"""Frozen-int8 weight state for serving (counterpart of the
``quantize_state_int8`` family in paddle_tpu/quantization/__init__.py).

A frozen state dict stores each quantized leaf as int8 under its
original name plus an f32 scalar companion ``name + SCALE_SUFFIX``.
Every 2-D float leaf freezes per tensor:
``q = clip(round(w / scale * 127), -127, 127)`` with
``scale = max(abs(w).max(), 1e-9)``; dequant is always
``q_f32 * (scale / 127.0)`` in exactly that order (`dequant_int8`).
Both are IEEE-exact elementwise formulas, so the results are bitwise
equal to the reference's on any device.
"""

from __future__ import annotations

import torch

__all__ = ["SCALE_SUFFIX", "quantize_state_int8", "is_quantized_state",
           "dequantize_state"]

SCALE_SUFFIX = "@scale"


def quantize_state_int8(values):
    """Freeze a flat ``{name: tensor}`` state dict for serving: every
    2-D (or higher) float leaf becomes int8 with a per-tensor abs-max
    scale stored as the f32 0-d leaf ``name + SCALE_SUFFIX``. 1-D leaves
    (LayerNorm, biases) and non-float leaves pass through unchanged.
    Runs on whatever device the leaves live on."""
    out = {}
    for name, v in values.items():
        if v.ndim < 2 or not v.is_floating_point():
            out[name] = v
            continue
        w = v.detach().float()
        scale = torch.clamp_min(w.abs().max(), 1e-9)
        q = torch.clamp(torch.round(w / scale * 127.0), -127, 127)
        out[name] = q.to(torch.int8)
        out[name + SCALE_SUFFIX] = scale
    return out


def is_quantized_state(values):
    """True when `values` carries frozen-int8 companions."""
    return any(k.endswith(SCALE_SUFFIX) for k in values)


def dequantize_state(values):
    """Inverse of `quantize_state_int8`: a dict of exactly the model's
    leaf names with every frozen leaf rebuilt as
    ``dequant_int8(q, scale)`` f32."""
    from ..ops.quant_ops import dequant_int8

    out = {}
    for name, v in values.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        scale = values.get(name + SCALE_SUFFIX)
        out[name] = v if scale is None else dequant_int8(v, scale)
    return out
