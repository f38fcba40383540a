"""Containers (ref paddle_tpu/nn/layer/container.py)."""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential"]


class Sequential(nn.Sequential):
    """paddle's Sequential: layers, an OrderedDict of named layers, or
    ``(name, layer)`` tuples; indexable, sliceable, with a length."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
        elif layers and all(isinstance(lyr, tuple) for lyr in layers):
            super().__init__(OrderedDict(layers))
        else:
            super().__init__(*layers)
