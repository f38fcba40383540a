"""Functional ops of the ported slices (ref paddle_tpu/nn/functional).

Ops that the reference dispatches under an AMP-listed name read the
port's `amp` policy for their inputs (`linear` and `matmul` as
``matmul_v2``, `cross_entropy`, `layer_norm`, `flash_attention`,
`fused_linear_cross_entropy`, `conv2d`, `batch_norm`), so
under ``amp.auto_cast`` they see the dtypes the reference's ops see;
`fused_conv2d_bn_act` applies its own cast rule. Random ops draw from
the generator that `framework.random.rng_scope` installs (an engine's),
else from torch's default one.

The batch-norm ops return y and write the new running stats into the
given buffers in place under ``no_grad`` (the reference's
``set_value``), in training unless `use_global_stats`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ... import amp
from ...framework import random as _random
from ...ops import fused_conv, fused_loss, fused_ops, lowp, nn_ops

__all__ = ["linear", "matmul", "gelu", "tanh", "relu", "dropout",
           "layer_norm", "cross_entropy", "fused_linear_cross_entropy",
           "scaled_dot_product_attention", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "batch_norm", "fused_bn_act",
           "fused_conv2d_bn_act", "pad"]

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
    product plus an f32 bias promotes to f32, as in the reference.
    With ``FLAGS_lowp_matmul`` on, `ops.lowp.maybe_linear` is asked
    first: a routed product reads the raw operands (no amp cast) and
    comes back in their promoted dtype."""
    y = lowp.maybe_linear(x, weight)
    if y is None:
        y = matmul(x, weight)
    return y if bias is None else y + bias


def gelu(x, approximate=False):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def relu(x, name=None):
    return torch.relu(x)


def _keep_mask(x, p):
    """The keep mask of a dropout of `x` at rate `p`, from the installed
    generator (`framework.random`)."""
    return torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=_random.generator_for(x.device)).bool()


def dropout(x, p=0.5, training=True):
    """Upscale-in-train dropout; identity in eval or at p == 0. Kept
    values are multiplied by ``1 / (1 - p)`` in x's dtype, as the
    reference's ``dropout`` op does."""
    if not training or p == 0.0:
        return x
    keep = _keep_mask(x, p)
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
    the probabilities from the installed generator (kept values divided
    by ``1 - p``)."""
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
    if use_dropout:
        # the reference's masked path divides by 1 - p in the
        # probabilities' dtype (its dropout op multiplies by 1 / (1 - p));
        # a tensor divisor keeps the division IEEE on CUDA
        # (`ops.quant_ops.true_div`)
        keep = _keep_mask(probs, p)
        probs = torch.where(
            keep, probs / torch.tensor(1.0 - p, dtype=probs.dtype,
                                       device=probs.device),
            torch.zeros((), dtype=probs.dtype, device=probs.device))
    return torch.matmul(probs, v).transpose(1, 2)


# -- conv, pooling, batch norm (the ResNet slice) ---------------------------


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """AMP white list; the bias is added outside the op (it promotes a
    low-precision conv to float32, as in the reference)."""
    x, weight = amp.cast("conv2d", x, weight)
    out = nn_ops.conv2d(x, weight, stride=stride, padding=padding,
                        dilation=dilation, groups=groups,
                        data_format=data_format)
    if bias is not None:
        shape = [1, -1, 1, 1] if data_format == "NCHW" else [1, 1, 1, -1]
        out = out + bias.reshape(shape)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported yet")
    return nn_ops.pool2d(x, ksize=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         pooling_type="max", data_format=data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return nn_ops.pool2d(x, ksize=output_size, adaptive=True,
                         pooling_type="avg", data_format=data_format)


def _write_stats(running_mean, running_var, new_mean, new_var):
    with torch.no_grad():
        running_mean.copy_(new_mean)
        running_var.copy_(new_var)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """AMP black list: every tensor enters in float32."""
    if use_global_stats is None:
        use_global_stats = not training
    xs, w, b, mean, var = amp.cast("batch_norm", x, weight, bias,
                                   running_mean, running_var)
    y, (new_mean, new_var) = nn_ops.batch_norm(
        xs, w, b, mean, var, momentum=momentum, epsilon=epsilon,
        is_test=not training, data_format=data_format,
        use_global_stats=use_global_stats)
    if training and not use_global_stats:
        _write_stats(running_mean, running_var, new_mean, new_var)
    return y


def fused_bn_act(x, running_mean, running_var, weight, bias,
                 residual=None, act="relu", training=False, momentum=0.9,
                 epsilon=1e-5, data_format="NCHW", use_global_stats=None,
                 name=None):
    """act(batch_norm(x) [+ residual]) through the minimal-residual VJP
    (`ops.nn_ops._BnActCore`): the backward recomputes the normalised
    activation instead of saving y or a mask."""
    if use_global_stats is None:
        use_global_stats = not training
    y, (new_mean, new_var) = nn_ops.fused_bn_act(
        x, weight, bias, running_mean, running_var, residual,
        momentum=momentum, epsilon=epsilon, act=act, is_test=not training,
        data_format=data_format, use_global_stats=use_global_stats)
    if training and not use_global_stats:
        _write_stats(running_mean, running_var, new_mean, new_var)
    return y


def fused_conv2d_bn_act(x, weight, running_mean, running_var, bn_weight,
                        bn_bias, residual=None, act="relu", training=False,
                        momentum=0.9, epsilon=1e-5, stride=1, padding=0,
                        dilation=1, groups=1, data_format="NCHW",
                        use_global_stats=None, name=None):
    """act(batch_norm(conv2d(x, weight)) [+ residual]) through the
    fused-epilogue conv (`ops.fused_conv`, kernel B10 on CUDA tensors):
    eval folds the BN into the conv's epilogue, training takes the BN
    moments from the conv's accumulator."""
    if use_global_stats is None:
        use_global_stats = not training
    y, (new_mean, new_var) = fused_conv.fused_conv2d_bn_act(
        x, weight, bn_weight, bn_bias, running_mean, running_var, residual,
        stride=stride, padding=padding, dilation=dilation, groups=groups,
        momentum=momentum, epsilon=epsilon, act=act, is_test=not training,
        data_format=data_format, use_global_stats=use_global_stats)
    if training and not use_global_stats:
        _write_stats(running_mean, running_var, new_mean, new_var)
    return y


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """paddle's pad: a full ``[lo, hi]`` per dim (2 * ndim entries), or
    pairs for the trailing spatial dims in `data_format` order, the
    first pair on the first spatial dim."""
    if len(pad) == 2 * x.dim():
        paddings = list(pad)
    else:
        spatial = len(pad) // 2
        lead = [0, 0] * (x.dim() - spatial)
        if data_format.startswith("NC"):
            paddings = lead + list(pad)
        else:
            paddings = [0, 0] + list(pad) + [0, 0]
    # torch lists the pairs from the last dim back
    tpad = []
    for i in reversed(range(x.dim())):
        tpad += [int(paddings[2 * i]), int(paddings[2 * i + 1])]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    return tF.pad(x, tpad, mode=mode,
                  value=value if mode == "constant" else None)
