"""Activation layers (ref paddle_tpu/nn/layer/activation.py): each calls
its `nn.functional` op with the arguments it was built with."""

from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
           "Silu", "Swish", "Mish", "Hardswish", "Softsign", "SELU", "GELU",
           "LeakyReLU", "ELU", "CELU", "Hardtanh", "Hardsigmoid",
           "Hardshrink", "Softshrink", "Softplus", "PReLU", "Softmax",
           "LogSoftmax", "Maxout", "ThresholdedReLU"]


def _simple(name, fn, **defaults):
    def __init__(self, name=None, **kwargs):
        Layer.__init__(self)
        self._kwargs = {**defaults, **kwargs}

    def forward(self, x):
        return fn(x, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
Sigmoid = _simple("Sigmoid", F.sigmoid)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Tanh = _simple("Tanh", F.tanh)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Silu = _simple("Silu", F.silu)
Swish = _simple("Swish", F.swish)
Mish = _simple("Mish", F.mish)
Hardswish = _simple("Hardswish", F.hardswish)
Softsign = _simple("Softsign", F.softsign)
SELU = _simple("SELU", F.selu)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class PReLU(Layer):
    """weight [num_parameters] when 1, else [1, num_parameters, 1, 1]."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, generator=None):
        super().__init__()
        shape = [num_parameters] if num_parameters == 1 else \
            [1, num_parameters, 1, 1]
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=I.Constant(init),
            generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups = groups
        self._axis = axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)
