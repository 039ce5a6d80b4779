"""Offline evaluation: the discriminator-feature FID."""
