"""Normalisation layers (ref paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

from torch import nn

from .. import functional as F
from .. import initializer as I

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(I.Constant(1.0)(self.normalized_shape))
        self.bias = nn.Parameter(I.Constant(0.0)(self.normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
