"""Layers (ref paddle_tpu/nn/layer)."""
