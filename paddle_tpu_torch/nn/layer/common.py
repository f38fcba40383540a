"""Common layers (ref paddle_tpu/nn/layer/common.py).

Parameters keep paddle's layouts so state dicts map one to one onto
``paddle_tpu.engine.state_values``: `Linear.weight` is ``[in, out]``
and computes ``x @ W + b``; `Embedding.weight` is ``[num, dim]``.
Parameters are initialised on the CPU from the given generator (the
default generator when None), so the same seed gives the same weights
on every device; the owning model moves them afterwards.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .. import initializer as I

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """y = x @ W + b, W: [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        init = weight_attr or I.XavierNormal()
        self.weight = nn.Parameter(
            init([in_features, out_features], generator))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = nn.Parameter(I.Constant(0.0)([out_features]))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 generator=None):
        super().__init__()
        init = weight_attr or I.XavierNormal()
        self.weight = nn.Parameter(
            init([num_embeddings, embedding_dim], generator))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
