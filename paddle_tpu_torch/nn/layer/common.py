"""Common layers (ref paddle_tpu/nn/layer/common.py).

Parameters keep paddle's layouts so state dicts map one to one onto
``paddle_tpu.engine.state_values``: `Linear.weight` is ``[in, out]``
and computes ``x @ W + b``; `Embedding.weight` is ``[num, dim]``.
Parameters are made by `Layer.create_parameter` from ``weight_attr`` /
``bias_attr`` (a `ParamAttr`, an initializer, a name, or False for no
bias), initialised on the CPU from the given generator (the default
generator when None), so the same seed gives the same weights on every
device; the owning model moves them afterwards.
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x @ W + b, W: [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, generator=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal(), generator=generator)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 generator=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal(), generator=generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
