"""Compatibility layer: import trained reference (Keras .h5) weights."""
