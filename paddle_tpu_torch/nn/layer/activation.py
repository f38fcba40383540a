"""Activation layers (ref paddle_tpu/nn/layer/activation.py)."""

from __future__ import annotations

from .layers import Layer

from .. import functional as F

__all__ = ["ReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)
