"""Automatic mixed precision (counterpart of paddle_tpu/amp and the AMP
rewrite of paddle_tpu/core/dispatch.py).

`auto_cast` sets a thread-local policy that the port's own ops read at
their entry (`cast`, under the reference's dispatched op name):

* O1: an op on the white list gets its floating inputs in the low
  dtype, an op on the black list gets them in float32, and any other op
  keeps its inputs as they are, so mixed operands promote as usual (a
  bf16 matmul plus an f32 bias is f32).
* O2: the black list still gets float32, and every other op gets its
  floating inputs in the low dtype, whatever its name.

float64 inputs are left alone. These are the reference's own lists and
rule, copied here. ``torch.autocast`` is not used because its lists
differ (it would run Linear as one bf16 ``addmm`` and change every
activation between matmuls), and a mode that cast every torch call
would also cast the torch calls inside the port's black-list ops (the
f32 statistics of ``layer_norm``); the port casts where the reference
dispatches: at each public op's entry, and where model code writes a
Tensor operator the reference dispatches (`binary`).

`decorate` casts a model's parameters and floating buffers to the low
dtype for O2 (no master copy: the optimizers compute in f32 and write
back in the parameter's dtype, as the reference's do), `GradScaler` is
the eager dynamic loss scaling, and `all_finite` the one finiteness bit
both it and the engine's guard take.
"""

from __future__ import annotations

import contextlib
import operator
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "cast", "binary", "policy",
           "policy_scope", "all_finite", "decorate", "GradScaler",
           "AMP_WHITE_LIST", "AMP_BLACK_LIST"]

# paddle_tpu/core/dispatch.py:24-36
AMP_WHITE_LIST = {
    "matmul_v2", "matmul", "mul", "conv2d", "conv2d_transpose", "conv1d",
    "conv3d", "depthwise_conv2d", "einsum", "fused_attention",
    "flash_attention", "bmm", "addmm", "fused_linear_cross_entropy",
}

AMP_BLACK_LIST = {
    "softmax_with_cross_entropy", "cross_entropy", "log_softmax", "exp",
    "log", "log2", "log10", "log1p", "mean", "sum", "reduce_sum",
    "reduce_mean", "softmax", "layer_norm", "batch_norm", "norm", "cumsum",
    "pow", "rsqrt", "erf", "erfinv", "sigmoid_cross_entropy_with_logits",
    "nll_loss", "kldiv_loss",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_LEVELS = ("O0", "O1", "O2")

_tls = threading.local()


def _state():
    """(low dtype, white set, black set, level) while auto_cast is on,
    else None."""
    return getattr(_tls, "state", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Mixed precision for the port's ops inside the block (this thread
    only). Custom lists extend the default ones. As in the reference,
    any enabled level but O2 applies the two lists alone (O0 included)."""
    prev = _state()
    if enable:
        if level not in _LEVELS:
            raise ValueError(f"auto_cast level must be one of {_LEVELS}, "
                             f"got {level!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"auto_cast dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        _tls.state = (_DTYPES[dtype],
                      AMP_WHITE_LIST | set(custom_white_list or ()),
                      AMP_BLACK_LIST | set(custom_black_list or ()), level)
    try:
        yield
    finally:
        _tls.state = prev


amp_guard = auto_cast  # the legacy fluid name, as in the reference


def policy():
    """This thread's current auto_cast policy (an opaque value for
    `policy_scope`; None when auto_cast is off)."""
    return _state()


@contextlib.contextmanager
def policy_scope(state):
    """Run the block under a policy taken earlier with `policy` (the
    recomputed forward of `recompute` replays its first run's casts,
    whatever the policy around the backward is)."""
    prev = _state()
    _tls.state = state
    try:
        yield
    finally:
        _tls.state = prev


def _cast_to(t, dtype):
    if isinstance(t, torch.Tensor) and t.is_floating_point() and \
            t.dtype != dtype and t.dtype != torch.float64:
        return t.to(dtype)
    return t


def cast(op_name, *tensors):
    """The reference's rewrite of op `op_name`'s inputs (the black list
    wins over the white list; under O2 every op not black-listed casts
    to the low dtype); returns them as a tuple."""
    st = _state()
    if st is None:
        return tensors
    low, white, black, level = st
    if op_name in black:
        return tuple(_cast_to(t, torch.float32) for t in tensors)
    if op_name in white or level == "O2":
        return tuple(_cast_to(t, low) for t in tensors)
    return tensors


_BINARY = {"elementwise_add": operator.add, "elementwise_sub": operator.sub,
           "elementwise_mul": operator.mul,
           "elementwise_div": operator.truediv,
           "elementwise_pow": operator.pow}


def binary(op_name, x, y):
    """``x <op> y`` for a Tensor operator the reference dispatches
    (``elementwise_add`` for ``x + y``, ``elementwise_sub``,
    ``elementwise_mul``, ``elementwise_div``, ``elementwise_pow``; either
    side may be a Python number), with its inputs cast as
    the reference casts them: under O2 a residual ``x + h`` of an f32 and
    a bf16 operand is bf16, as in the reference (torch would promote it
    to f32). With amp off, or under O1 (none of these is listed), it is
    the torch operator itself, bit for bit."""
    x, y = cast(op_name, x, y)
    return _BINARY[op_name](x, y)


def all_finite(tree):
    """One device bool: every element of every tensor is finite. A
    nested list / tuple / dict of tensors (None entries skipped), fused
    into one reduction over per-tensor bits, with no host
    synchronisation (the reference's ``all_finite``; True for none)."""
    leaves = [t for t in _leaves(tree) if t is not None]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every model's parameters and floating buffers to `dtype`
    (the reference's ``Layer.to(dtype=)``); O1 leaves them. As in the
    reference there is no master copy: `master_weight` and `save_dtype`
    are accepted and unused, and each optimizer rule computes in f32
    from the low-precision parameter and writes back in its dtype.
    Returns `models`, or ``(models, optimizers)`` when optimizers are
    given."""
    if level == "O2":
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=dtype)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling for the eager loop (the reference's
    ``GradScaler``, paddle's grad_scaler.py over
    check_finite_and_unscale / update_loss_scaling):
    ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update()``
    or ``scaler.minimize(opt, scaled)``. `unscale_` divides every
    gradient of the optimizer's parameters by the scale in place, in
    their own dtypes, with one fused finiteness bit and ONE host read
    per call; `step` skips the optimizer's update when that bit is
    false. The scale shrinks by `decr_ratio` after
    `decr_every_n_nan_or_inf` consecutive bad steps (not below 1) and
    grows by `incr_ratio` after `incr_every_n_steps` consecutive good
    ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # optimizers unscaled since the last update(): step() must not
        # divide by the scale a second time
        self._unscaled = set()

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Divide the gradients of `optimizer`'s parameters by the scale
        (once between two `update` calls; a second call raises) and
        record whether every one of them is finite."""
        if not self._enable:
            return
        if id(optimizer) in self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        grads = [p.grad for p in optimizer._parameter_list or ()
                 if p is not None and p.grad is not None]
        if grads:
            inv = 1.0 / self._scale
            with torch.no_grad():
                # keep each gradient's dtype (an f16 one stays f16)
                torch._foreach_mul_(grads, inv)
            self._found_inf = not bool(all_finite(grads))
        self._unscaled.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) not in self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
