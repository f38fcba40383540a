"""Normalisation layers (ref paddle_tpu/nn/layer/norm.py).

The batch-norm layers keep paddle's names: parameters ``weight`` and
``bias``, running-stat buffers ``_mean`` (zeros) and ``_variance``
(ones), so state dicts map name for name onto
``paddle_tpu.engine.state_values``. ``momentum`` is paddle's (the
weight of the OLD running stat); the stats are written by
`nn.functional` in the reference's formula, never by torch's batch
norm. ``SyncBatchNorm`` waits for the distributed slice."""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def _is_plain(self):
        """True when this layer's forward is exactly the stock
        F.batch_norm above, so model-level fusions (fused_bn_act /
        fused_conv2d_bn_act) may bypass the module call; subclass
        forwards and hook-carrying layers keep the composed path."""
        return (type(self).forward is _BatchNormBase.forward
                and not self._forward_pre_hooks
                and not self._forward_hooks)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    """Legacy fluid-style BatchNorm (acts like BatchNorm2D)."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self.normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
