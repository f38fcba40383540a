"""Pooling layers (ref paddle_tpu/nn/layer/pooling.py): each calls its
`nn.functional` pool with the arguments it was built with."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool3d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, None,
                            self.data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool3d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, None,
                            self.data_format)


class _Adaptive(Layer):
    def __init__(self, output_size, return_mask=False, data_format=None,
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format


class AdaptiveAvgPool1D(_Adaptive):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_Adaptive):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(_Adaptive):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(_Adaptive):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_Adaptive):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_Adaptive):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
