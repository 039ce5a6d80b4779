"""Reference-signature-compatible entry points."""
