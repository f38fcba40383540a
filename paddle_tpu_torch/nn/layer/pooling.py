"""Pooling layers (ref paddle_tpu/nn/layer/pooling.py)."""

from __future__ import annotations

from .layers import Layer

from .. import functional as F

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
