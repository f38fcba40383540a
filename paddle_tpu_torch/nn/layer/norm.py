"""Normalisation layers (ref paddle_tpu/nn/layer/norm.py).

The batch-norm layers keep paddle's names: parameters ``weight`` and
``bias``, running-stat buffers ``_mean`` (zeros) and ``_variance``
(ones), so state dicts map name for name onto
``paddle_tpu.engine.state_values``. ``momentum`` is paddle's (the
weight of the OLD running stat); the stats are written by
`nn.functional` in the reference's formula, never by torch's batch
norm. ``SyncBatchNorm`` waits for the distributed slice.

`LayerNorm`'s parameters are flat ``[prod(normalized_shape)]`` vectors,
as the reference's. `SpectralNorm` holds its power-iteration vectors as
the frozen parameters ``weight_u [h]`` and ``weight_v [w]`` (drawn
N(0, 1)) and divides the weight it is given by its estimated largest
singular value; like the reference's op it does not update them.
`RMSNorm` normalises over the last axis (AMP name ``rms_norm``)."""

from __future__ import annotations

import math

import torch

from ... import amp
from ...ops import extra_ops, nn_ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm", "RMSNorm"]


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
                 bias_attr=None, name=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        n = math.prod(self.normalized_shape)
        self.weight = self.create_parameter(
            [n], attr=weight_attr, default_initializer=I.Constant(1.0),
            generator=generator)
        self.bias = self.create_parameter([n], attr=bias_attr, is_bias=True,
                                          generator=generator)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, generator=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0), generator=generator)
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True,
            generator=generator)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    """Instance norm over any NC... input (the reference's one class
    under three names); ``weight_attr=False`` or ``bias_attr=False``
    drops both parameters."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0), generator=generator)
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True,
                generator=generator)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, generator=None):
        super().__init__()
        dim = dim % len(weight_shape)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0), generator=generator)
        self.weight_u.trainable = False
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0), generator=generator)
        self.weight_v.trainable = False

    def forward(self, weight):
        weight, u, v = amp.cast("spectral_norm", weight, self.weight_u,
                                self.weight_v)
        return extra_ops.spectral_norm(weight, u, v, dim=self._dim,
                                       power_iters=self._power_iters,
                                       eps=self._eps)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 generator=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0), generator=generator)

    def forward(self, x):
        x, w = amp.cast("rms_norm", x, self.weight)
        return nn_ops.rms_norm(x, w, epsilon=self._epsilon)
