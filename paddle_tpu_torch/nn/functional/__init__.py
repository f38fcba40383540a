"""Functional ops of the ported slices (ref paddle_tpu/nn/functional).

Ops that the reference dispatches under an AMP-listed name read the
port's `amp` policy for their inputs (`linear` and `matmul` as
``matmul_v2``, `cross_entropy`, `layer_norm`, `flash_attention`,
`fused_linear_cross_entropy`), so
under ``amp.auto_cast`` they see the dtypes the reference's ops see.
Random ops draw from the generator that `framework.random.rng_scope`
installs (an engine's), else from torch's default one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ... import amp
from ...framework import random as _random
from ...ops import fused_loss, fused_ops

__all__ = ["linear", "matmul", "gelu", "tanh", "dropout", "layer_norm",
           "cross_entropy", "fused_linear_cross_entropy",
           "scaled_dot_product_attention"]

# additive mask value of the reference's attention paths (a large finite
# negative, not -inf, so a fully masked row cannot turn into NaN)
NEG_INF = -1e30


def matmul(x, y, transpose_y=False):
    """The reference's ``matmul_v2`` (AMP white list)."""
    x, y = amp.cast("matmul_v2", x, y)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def linear(x, weight, bias=None):
    """y = x @ W + b with W in paddle's [in, out] layout: a ``matmul_v2``
    then an add outside the AMP lists, so under bf16 auto_cast a bf16
    product plus an f32 bias promotes to f32, as in the reference."""
    y = matmul(x, weight)
    return y if bias is None else y + bias


def gelu(x, approximate=False):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def dropout(x, p=0.5, training=True):
    """Upscale-in-train dropout; identity in eval or at p == 0. The mask
    comes from the installed generator (`framework.random`)."""
    if not training or p == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=_random.generator_for(x.device)).bool()
    scale = torch.tensor(1.0 / (1.0 - p), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """AMP black list: normalised in float32."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp.cast("layer_norm", x, weight, bias)
    return tF.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy over the last axis in float32 (AMP black
    list). Rows whose label is `ignore_index` contribute 0; "mean"
    divides by the number of the other rows (at least 1)."""
    (logits,) = amp.cast("cross_entropy", input)
    logp = torch.log_softmax(logits.float(), dim=-1)
    lbl = label.long()
    if lbl.dim() == logp.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    picked = torch.gather(logp, -1, lbl.clamp_min(0).unsqueeze(-1))
    valid = lbl != ignore_index
    loss = -picked.squeeze(-1) * valid.float()
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.float().sum().clamp_min(1.0)


def fused_linear_cross_entropy(hidden, weight, label, ignore_index=-100,
                               reduction="mean", chunk_v=0):
    """cross_entropy(hidden @ weight.T, label) as one streaming op that
    never forms the ``[N, V]`` logits (`ops.fused_loss`: kernels B4-B6
    on CUDA tensors). AMP white list: under bf16 auto_cast the hidden
    states and the table enter as bf16, and the table's gradient comes
    back to the f32 parameter through the cast's own backward."""
    hidden, weight = amp.cast("fused_linear_cross_entropy", hidden, weight)
    return fused_loss.fused_linear_cross_entropy(
        hidden, weight, label, ignore_index=ignore_index,
        reduction=reduction, chunk_v=chunk_v)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
    """Attention over head-major ``[b, h, s, d]`` inputs, returning
    ``[b, s, h, d]`` (the reference's ``qkv_layout='bhsd'`` mode).

    Without a mask it is `ops.fused_ops.flash_attention` (kernels B1-B3
    on CUDA tensors), dropout in-kernel from one 32-bit seed per call.
    With an additive (float) or boolean mask it is the reference's plain
    op: f32 scores, causal mask aligned bottom-right, softmax, dropout of
    the probabilities from the installed generator."""
    use_dropout = dropout_p > 0.0 and training
    p = dropout_p if use_dropout else 0.0
    if attn_mask is None:
        q, k, v = amp.cast("flash_attention", q, k, v)
        seed = _random.next_seed(q.device) if use_dropout else None
        out = fused_ops.flash_attention(q, k, v, seed, is_causal=is_causal,
                                        dropout_p=p)
        return out.transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    s = s.float()
    if is_causal:
        s = fused_ops._causal_fill(s)
    if attn_mask.dtype == torch.bool:
        s = s.masked_fill(~attn_mask, NEG_INF)
    else:
        s = s + attn_mask
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    probs = dropout(probs, p, training=use_dropout)
    return torch.matmul(probs, v).transpose(1, 2)
