"""GAN architectures."""
