"""Platform, PRNG streams, data pipeline, metrics and checkpoints."""
