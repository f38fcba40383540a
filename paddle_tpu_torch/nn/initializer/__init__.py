"""Parameter initializers (ref paddle_tpu/nn/initializer). Each is called
with a shape and an explicit `torch.Generator` (None: torch's default
CPU generator) and returns a new float32 CPU tensor; the module that
owns the parameter moves it.

Fans follow the reference's rule: a matrix is paddle's ``[in, out]``
(fan_in = shape[0], fan_out = shape[1]), a conv weight ``[out, in,
*k]`` (fan_in = in * prod(k), fan_out = out * prod(k)), a vector's fans
are its length. The draws themselves differ from the reference's JAX
streams; the distributions are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac", "constant",
           "normal", "uniform"]


def _fan_in_out(shape):
    shape = list(shape)
    if not shape:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _gain(nonlinearity, negative_slope):
    return math.sqrt(2.0 / (1 + negative_slope ** 2)) \
        if nonlinearity in ("relu", "leaky_relu") else 1.0


class Initializer:
    """Base: ``init(shape, generator=None) -> float32 CPU tensor``."""

    def __call__(self, shape, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, shape, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator=None):
        return torch.empty(tuple(shape), dtype=torch.float32).normal_(
            self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """mean + std * a standard normal truncated to [-2, 2]."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator=None):
        t = torch.nn.init.trunc_normal_(
            torch.empty(tuple(shape), dtype=torch.float32), 0.0, 1.0, -2.0,
            2.0, generator=generator)
        return self.mean + self.std * t


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, shape, generator=None):
        return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
            self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    """Glorot normal: std = gain * sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / float(fi + fo))
        return Normal(0.0, std)(shape, generator)


class XavierUniform(Initializer):
    """Glorot uniform: U(-limit, limit), limit = gain * sqrt(6 / (fan_in
    + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / float(fi + fo))
        return Uniform(-limit, limit)(shape, generator)


class KaimingNormal(Initializer):
    """He normal: N(0, gain / sqrt(fan_in)), gain sqrt(2 / (1 +
    slope^2)) for relu / leaky_relu, else 1."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, generator=None):
        fi = self._fan_in if self._fan_in is not None else \
            _fan_in_out(shape)[0]
        std = _gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return Normal(0.0, std)(shape, generator)


class KaimingUniform(Initializer):
    """He uniform: U(-limit, limit), limit = gain * sqrt(3 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, generator=None):
        fi = self._fan_in if self._fan_in is not None else \
            _fan_in_out(shape)[0]
        limit = _gain(self.nonlinearity, self.negative_slope) * \
            math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, generator)


class Assign(Initializer):
    """The given values (reshaped to the parameter's shape)."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, generator=None):
        v = self.value
        arr = v.detach().cpu().float() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v, dtype=np.float32))
        return arr.reshape(tuple(shape)).clone()


class Orthogonal(Initializer):
    """gain * an orthonormal matrix over (prod(shape[:-1]), shape[-1])
    (``jax.nn.initializers.orthogonal``'s layout): Q of the QR of a
    normal draw, its columns' signs fixed by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, generator=None):
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        a = torch.empty(mshape, dtype=torch.float64).normal_(
            generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q).reshape(shape).float()


class Dirac(Initializer):
    """Identity-preserving conv weight: ``w[i, i % in, centre] = 1`` for
    i < min(out, in * groups)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, generator=None):
        out = torch.zeros(tuple(shape), dtype=torch.float32)
        oc, ic = shape[0], shape[1]
        centres = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centres] = 1.0
        return out


# paddle aliases
constant = Constant
normal = Normal
uniform = Uniform
