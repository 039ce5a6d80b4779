"""Keras-semantics layers and spectral normalization."""
