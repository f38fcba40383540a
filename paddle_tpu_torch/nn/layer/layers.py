"""nn.Layer and Parameter (counterpart of paddle_tpu/nn/layer/layers.py
and the reference's ``Parameter``).

`Layer` is a ``torch.nn.Module`` with paddle's two construction and
loading methods: `create_parameter`, which follows the reference's
rules (the attribute's initializer, else the default one, else zeros
for a bias, else XavierNormal), and `set_state_dict`, which copies numpy
arrays or tensors in place under structured names. A `Parameter`
assigned to a layer without a name gets the reference's automatic one,
``<class name in lower case>_<n>.<attribute>``, n counting the layers
of that class in construction order, so name-based rules (LARS
exclusions, ``apply_decay_param_fun``, the eager optimizer's
``state_dict`` keys) read the same names in both packages.

`Parameter` is a ``torch.nn.Parameter`` that carries paddle's
per-parameter attributes as Python attributes: ``name``,
``optimize_attr`` (``{"learning_rate": multiplier}``),
``regularizer``, ``need_clip`` and ``trainable`` (which is
``requires_grad``). They survive ``Layer.to(device)`` (torch moves the
data under the same object) and ``copy.deepcopy``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import initializer as I
from ...param_attr import ParamAttr

__all__ = ["Layer", "Parameter"]

_auto_name_counters: dict = {}

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}


def _auto_prefix(layer):
    """The layer's stable prefix such as ``linear_0`` (the reference's
    unique-name generator), kept on the instance."""
    cached = layer.__dict__.get("_auto_prefix_name")
    if cached is None:
        cls = type(layer).__name__.lower()
        n = _auto_name_counters.get(cls, 0)
        _auto_name_counters[cls] = n + 1
        cached = f"{cls}_{n}"
        layer.__dict__["_auto_prefix_name"] = cached
    return cached


class Parameter(torch.nn.Parameter):
    """A trainable tensor with paddle's per-parameter attributes."""

    def __new__(cls, data=None, requires_grad=True):
        p = super().__new__(cls, data, requires_grad)
        p.__dict__.update(_name=None, optimize_attr={"learning_rate": 1.0},
                          regularizer=None, need_clip=True)
        return p

    # torch's Tensor.name is a read-only slot: paddle's lives in __dict__
    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


def _torch_sublayers(module, prefix):
    """`named_sublayers` of a plain torch module inside a Layer."""
    yield prefix, module
    for name, child in module.named_children():
        yield from _torch_sublayers(child, f"{prefix}.{name}")


class Layer(torch.nn.Module):
    """paddle's Layer on torch's Module."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or type(self).__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter) and value.name is None:
            value.name = f"{_auto_prefix(self)}.{name}"
        super().__setattr__(name, value)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, generator=None):
        """A new `Parameter` of `shape` drawn on the CPU (from
        `generator`, or torch's default generator when None), or None
        when `attr` is False."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        elif is_bias:
            init = I.Constant(0.0)
        else:
            init = I.XavierNormal()
        data = init(list(shape), generator)
        dtype = dtype or getattr(self, "_dtype", "float32")
        data = data.to(_DTYPES.get(dtype, dtype))
        p = Parameter(data, requires_grad=bool(attr.trainable))
        p.name = attr.name
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def to(self, *args, **kwargs):
        """torch's ``Module.to`` that also takes paddle's form
        ``to(device=None, dtype=None, blocking=None)`` with dtype names
        (``"bfloat16"``): a dtype casts every floating parameter and
        buffer, in place under the same objects (their paddle attributes
        survive), as the reference's ``Layer.to(dtype=)``."""
        blocking = kwargs.pop("blocking", None)
        if blocking is not None:
            kwargs.setdefault("non_blocking", not blocking)
        if kwargs.get("device") is None:
            kwargs.pop("device", None)
        dtype = kwargs.get("dtype")
        if isinstance(dtype, str):
            kwargs["dtype"] = _DTYPES[dtype]
        args = tuple(_DTYPES[a] if isinstance(a, str) and a in _DTYPES
                     else a for a in args)
        out = super().to(*args, **kwargs)
        if dtype is not None:
            self._dtype = dtype if isinstance(dtype, str) else \
                str(dtype).replace("torch.", "")
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def add_parameter(self, name, parameter):
        """Register `parameter` (a `Parameter` or None) under `name`."""
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def full_name(self):
        """`name_scope`, or the class name in lower case."""
        return getattr(self, "_full_name", type(self).__name__.lower())

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        """``(structured name, layer)`` of every sublayer, depth first in
        registration order (this layer first under `include_self`), as
        the reference's."""
        if include_self:
            yield prefix, self
        for name, child in self.named_children():
            yield from child.named_sublayers(
                prefix=f"{prefix}.{name}" if prefix else name,
                include_self=True) if isinstance(child, Layer) else \
                _torch_sublayers(child, f"{prefix}.{name}" if prefix
                                 else name)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward (a non-None
        return replaces the outputs); returns a handle whose ``remove()``
        undoes it. The hook is torch's forward hook, so the fusion
        predicates that read ``_forward_hooks`` see it."""
        return self.register_forward_hook(hook)

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict` (``{structured name: numpy array or
        tensor}``) into this layer's parameters and persistent buffers,
        in place, each on its own device and dtype. Raises on a shape
        mismatch; returns ``(missing, unexpected)`` names."""
        own = self.state_dict(keep_vars=True)
        missing = []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            src = src.detach() if isinstance(src, torch.Tensor) else \
                torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: {list(src.shape)} vs "
                    f"{list(target.shape)}")
            target.copy_(src.to(device=target.device, dtype=target.dtype))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict
