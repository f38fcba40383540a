"""Automatic mixed precision (counterpart of paddle_tpu/amp and the AMP
rewrite of paddle_tpu/core/dispatch.py).

`auto_cast` sets a thread-local policy that the port's own functional
ops read (`cast`): under O1, an op on the white list gets its floating
inputs in the low dtype, an op on the black list gets them in float32,
and any other op keeps its inputs as they are, so mixed operands promote
as usual (a bf16 matmul plus an f32 bias is f32). These are the
reference's own lists and rule, copied here; ``torch.autocast`` is not
used because its lists differ (it would run Linear as one bf16
``addmm`` and change every activation between matmuls). Level O2 (cast
every non-black op) is not ported yet and raises.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "cast", "policy", "policy_scope", "AMP_WHITE_LIST",
           "AMP_BLACK_LIST"]

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

_tls = threading.local()


def _state():
    """(low dtype, white set, black set) while auto_cast is on, else
    None."""
    return getattr(_tls, "state", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Mixed precision for the port's ops inside the block (this thread
    only). Custom lists extend the default ones."""
    prev = _state()
    if enable:
        if level != "O1":
            raise NotImplementedError(
                f"auto_cast level {level!r} is not ported yet (O1 only)")
        if dtype not in _DTYPES:
            raise ValueError(f"auto_cast dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        _tls.state = (_DTYPES[dtype],
                      AMP_WHITE_LIST | set(custom_white_list or ()),
                      AMP_BLACK_LIST | set(custom_black_list or ()))
    try:
        yield
    finally:
        _tls.state = prev


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
    """The reference's O1 rewrite of op `op_name`'s inputs (the black
    list wins over the white list); returns them as a tuple."""
    st = _state()
    if st is None:
        return tensors
    low, white, black = st
    if op_name in black:
        return tuple(_cast_to(t, torch.float32) for t in tensors)
    if op_name in white:
        return tuple(_cast_to(t, low) for t in tensors)
    return tensors
