"""Parameter initializers (ref python/paddle/nn/initializer). Each is
called with a shape and an explicit `torch.Generator` and returns a new
float32 CPU tensor; the module that owns the parameter moves it."""

from __future__ import annotations

import math

import torch

__all__ = ["Constant", "Normal", "XavierNormal"]


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, shape, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32)


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator=None):
        return torch.empty(tuple(shape), dtype=torch.float32).normal_(
            self.mean, self.std, generator=generator)


class XavierNormal:
    """Glorot normal over a paddle-layout [fan_in, fan_out] weight."""

    def __call__(self, shape, generator=None):
        fan_in, fan_out = shape[0], shape[-1]
        std = math.sqrt(2.0 / float(fan_in + fan_out))
        return Normal(0.0, std)(shape, generator)
