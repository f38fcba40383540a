"""Parameter initializers (ref python/paddle/nn/initializer). Each is
called with a shape and an explicit `torch.Generator` and returns a new
float32 CPU tensor; the module that owns the parameter moves it."""

from __future__ import annotations

import math

import torch

__all__ = ["Constant", "Normal", "Uniform", "XavierNormal", "KaimingUniform"]


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


class Uniform:
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, shape, generator=None):
        return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            self.low, self.high, generator=generator)


class KaimingUniform:
    """He uniform: U(-limit, limit), limit = gain * sqrt(3 / fan_in),
    gain sqrt(2 / (1 + slope^2)) for relu / leaky_relu, else 1. fan_in
    defaults to in * kh * kw of a conv weight [out, in, kh, kw] and to
    the first dim of a paddle-layout [in, out] matrix or a vector."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, generator=None):
        fan_in = self._fan_in if self._fan_in is not None else \
            (math.prod(shape[1:]) if len(shape) > 2 else shape[0])
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2)) \
            if self.nonlinearity in ("relu", "leaky_relu") else 1.0
        limit = gain * math.sqrt(3.0 / fan_in)
        return Uniform(-limit, limit)(shape, generator)
