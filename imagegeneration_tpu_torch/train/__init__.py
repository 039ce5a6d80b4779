"""Optimizer, losses, fused train steps and engines."""
