"""Convolution layers (ref paddle_tpu/nn/layer/conv.py): the weight is
``[out, in / groups, *k]`` (a transposed conv's ``[in, out / groups,
*k]``), KaimingUniform over ``fan_in = in / groups * prod(k)``; the bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), none with ``bias_attr=False``.
Parameters are made on the CPU from the given generator (the default
generator when None); the owning model moves them."""

from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, ndim, generator=None, transpose=False,
                 output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * ndim
        self._kernel_size = tuple(ks)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        wshape = [in_channels, out_channels // groups, *self._kernel_size] \
            if transpose else \
            [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in),
            generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound),
            generator=generator)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None):
        # padding_mode is taken and unused: zero padding, as the
        # reference's Conv2D (and this module's Conv1D / Conv3D)
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def _is_plain_for_fusion(self):
        """True when this layer's forward is exactly the stock bias-free
        F.conv2d above: the conv half of a fusable Conv->BN->act chain
        (vision.models.resnet._conv_bn_act). Subclass forwards, hooks,
        bias, groups and dilation keep the composed path."""
        return (type(self).forward is Conv2D.forward
                and self.bias is None
                and self._groups == 1
                and self._data_format == "NCHW"
                and _pair(self._dilation) == (1, 1)
                and not self._forward_pre_hooks
                and not self._forward_hooks)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _ConvTransposeNd(_ConvNd):
    _ndim, _fn, _format = 2, None, "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format or self._format, self._ndim, generator,
                         transpose=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._output_padding, self._dilation,
                        self._groups, self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _ndim, _fn, _format = 1, staticmethod(F.conv1d_transpose), "NCL"


class Conv2DTranspose(_ConvTransposeNd):
    _ndim, _fn, _format = 2, staticmethod(F.conv2d_transpose), "NCHW"


class Conv3DTranspose(_ConvTransposeNd):
    _ndim, _fn, _format = 3, staticmethod(F.conv3d_transpose), "NCDHW"
