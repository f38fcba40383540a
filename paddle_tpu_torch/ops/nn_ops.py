"""Neural-network ops of the ResNet slice (counterpart of the conv, pool
and batch-norm parts of paddle_tpu/ops/nn_ops.py).

`conv2d` sends an eligible NCHW conv through `ops.fused_conv` (kernel
B10 on CUDA tensors) and any other conv through torch's convolution, as
the reference sends it to ``lax.conv_general_dilated``. Pooling pads
with -inf (max) or counts the real elements (exclusive average) as the
reference's ``reduce_window`` does. Batch norm takes the reference's
one-pass statistics in float32, ``E[x^2] - E[x]^2`` clamped at 0 (the
BIASED variance; torch's own batch norm would write the unbiased one),
and its running stats follow paddle's convention, ``new = momentum *
old + (1 - momentum) * batch``: neither ``torch.nn.BatchNorm2d`` nor
``F.batch_norm`` may update them. These functions return the new stats;
`nn.functional` writes them into the layer's buffers.

`fused_bn_act` trains through `_BnActCore`, the reference's
minimal-residual VJP: it saves only its inputs ``(x, scale, bias, m,
inv, residual)`` and its backward recomputes the normalised activation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

__all__ = ["conv2d", "pool2d", "batch_norm", "batch_norm_apply",
           "fused_bn_act", "adaptive_bounds"]


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, spatial, strides, dilations, ksizes,
                  channel_last=False):
    """Normalise paddle padding spec to [(lo, hi), ...] or 'SAME' /
    'VALID'."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * spatial
    if len(padding) > 0 and all(isinstance(p, (list, tuple))
                                for p in padding):
        pairs = [(int(lo), int(hi)) for lo, hi in padding]
        if len(pairs) == spatial:
            return pairs
        if len(pairs) == spatial + 2:
            # paddle's full-rank form includes batch/channel pairs: NCHW
            # keeps them in front, NHWC wraps the spatial dims
            return pairs[1:-1] if channel_last else pairs[2:]
        raise ValueError(f"bad padding {padding!r}")
    pads = [int(p) for p in padding]
    if len(pads) == spatial:
        return [(p, p) for p in pads]
    if len(pads) == 2 * spatial:
        return [(pads[2 * i], pads[2 * i + 1]) for i in range(spatial)]
    raise ValueError(f"bad padding {padding!r}")


def _same_pads(sizes, ksizes, strides, dilations=(1, 1)):
    """lax's 'SAME' padding: the output is ceil(size / stride)."""
    out = []
    for size, k, s, d in zip(sizes, ksizes, strides, dilations):
        eff = (k - 1) * d + 1
        total = max(0, (-(-size // s) - 1) * s + eff - size)
        out.append((total // 2, total - total // 2))
    return out


def pad2d(x, pads, value=0.0):
    """Pad (or, for negative amounts, crop, as ``lax.pad`` does) the last
    two dims of `x` by ``((top, bottom), (left, right))``."""
    (t, b), (lf, r) = pads
    if t == b == lf == r == 0:
        return x
    return tF.pad(x, (lf, r, t, b), value=value)


def conv2d(x, weight, *, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    strides = _pair(stride)
    dilations = _pair(dilation)
    kh, kw = weight.shape[-2], weight.shape[-1]
    pad = _conv_padding(padding, 2, strides, dilations, (kh, kw),
                        channel_last=(data_format != "NCHW"))
    if data_format == "NCHW" and groups == 1:
        # kernel B10 and its transposed-conv VJP where the flag and the
        # plan allow (lazy import: fused_conv imports this module)
        from . import fused_conv

        z = fused_conv.conv2d_maybe_pallas(x, weight, strides, pad,
                                           dilations, groups, data_format)
        if z is not None:
            return z
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    if isinstance(pad, str):
        pad = [(0, 0)] * 2 if pad == "VALID" else _same_pads(
            x.shape[2:], (kh, kw), strides, dilations)
    out = tF.conv2d(pad2d(x, pad), weight, stride=strides,
                    dilation=dilations, groups=groups)
    return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out


# -- pooling ---------------------------------------------------------------


def _pool2d(x, ksize, stride, padding, ceil_mode, mode, exclusive,
            data_format):
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    ks = _pair(ksize)
    st = _pair(stride) if stride is not None else ks
    if isinstance(padding, str):
        pads = _same_pads(x.shape[2:], ks, st) \
            if padding.upper() == "SAME" else [(0, 0), (0, 0)]
    else:
        pads = list(_conv_padding(padding, 2, st, (1, 1), ks))
        if ceil_mode:
            # extra hi padding so ceil-division windows are produced
            extra = []
            for dim, k, s, (lo, hi) in zip(x.shape[2:], ks, st, pads):
                rem = (dim + lo + hi - k) % s
                extra.append((lo, hi + (s - rem) % s if rem else hi))
            pads = extra
    if mode == "max":
        init = -math.inf if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        out = tF.max_pool2d(pad2d(x, pads, init), ks, st)
    else:
        summed = tF.avg_pool2d(pad2d(x, pads), ks, st, divisor_override=1)
        if exclusive and any(p != (0, 0) for p in pads):
            counts = tF.avg_pool2d(pad2d(torch.ones_like(x), pads), ks, st,
                                   divisor_override=1)
            out = summed / counts
        else:
            out = summed / (ks[0] * ks[1])
    return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out


def pool2d(x, *, ksize, stride=None, padding=0, ceil_mode=False,
           pooling_type="max", exclusive=True, global_pooling=False,
           adaptive=False, data_format="NCHW"):
    if global_pooling:
        axes = (2, 3) if data_format == "NCHW" else (1, 2)
        if pooling_type == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.mean(dim=axes, keepdim=True)
    if adaptive:
        return _adaptive_pool2d(x, ksize, pooling_type, data_format)
    return _pool2d(x, ksize, stride, padding, ceil_mode, pooling_type,
                   exclusive, data_format)


def adaptive_bounds(i, size, bins):
    """Paddle adaptive-pool bin i over `size` elements in `bins` cells:
    [floor(i*size/bins), ceil((i+1)*size/bins))."""
    return (i * size) // bins, -(-((i + 1) * size) // bins)


def _adaptive_pool2d(x, output_size, mode, data_format):
    os_ = _pair(output_size)
    axes = (2, 3) if data_format == "NCHW" else (1, 2)
    h, w = x.shape[axes[0]], x.shape[axes[1]]
    if h % os_[0] == 0 and w % os_[1] == 0:
        ks = (h // os_[0], w // os_[1])
        return _pool2d(x, ks, ks, 0, False, mode, True, data_format)
    # non-divisible: paddle's bins overlap (start floor, end ceil)
    if data_format != "NCHW":
        x = x.movedim(-1, 1)
    rows = []
    for i in range(os_[0]):
        s0, e0 = adaptive_bounds(i, h, os_[0])
        cols = []
        for j in range(os_[1]):
            s1, e1 = adaptive_bounds(j, w, os_[1])
            win = x[:, :, s0:e0, s1:e1]
            cols.append(win.amax(dim=(2, 3)) if mode == "max"
                        else win.mean(dim=(2, 3)))
        rows.append(torch.stack(cols, dim=-1))
    out = torch.stack(rows, dim=-2)
    return out.movedim(1, -1) if data_format != "NCHW" else out


# -- batch norm ------------------------------------------------------------


def _stats(x, c_axis):
    """The batch mean and biased variance of `x` in float32, one pass:
    ``max(E[x^2] - E[x]^2, 0)``."""
    axes = tuple(a for a in range(x.dim()) if a != c_axis)
    x32 = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = x32.mean(dim=axes)
    var = torch.clamp_min((x32 * x32).mean(dim=axes) - mean * mean, 0.0)
    return mean, var


def _bshape(x, c_axis):
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return shape


def batch_norm_apply(x, scale, bias, mean, variance, use_mean, use_var,
                     *, momentum, epsilon, c_axis):
    """Normalise with (use_mean, use_var) and return the new running
    stats in paddle's convention."""
    bshape = _bshape(x, c_axis)
    new_mean = momentum * mean + (1 - momentum) * use_mean
    new_var = momentum * variance + (1 - momentum) * use_var
    inv = torch.rsqrt(use_var + epsilon)
    y = (x - use_mean.reshape(bshape).to(x.dtype)) * \
        inv.reshape(bshape).to(x.dtype)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return y, (new_mean.detach(), new_var.detach())


def batch_norm(x, scale, bias, mean, variance, *, momentum=0.9,
               epsilon=1e-5, is_test=False, data_format="NCHW",
               use_global_stats=False):
    """y and the new running stats; in training the batch statistics are
    differentiated through by autograd, as the reference's AD does."""
    c_axis = 1 if data_format == "NCHW" else x.dim() - 1
    if is_test or use_global_stats:
        bshape = _bshape(x, c_axis)
        inv = torch.rsqrt(variance + epsilon)
        y = (x - mean.reshape(bshape).to(x.dtype)) * \
            inv.reshape(bshape).to(x.dtype)
        y = y * scale.reshape(bshape) + bias.reshape(bshape)
        return y, (mean, variance)
    use_mean, use_var = _stats(x, c_axis)
    return batch_norm_apply(x, scale, bias, mean, variance, use_mean,
                            use_var, momentum=momentum, epsilon=epsilon,
                            c_axis=c_axis)


# -- fused BN + activation (+ residual) -------------------------------------


def _bn_act_math(act, c_axis, x, scale, bias, m, inv, residual):
    bshape = _bshape(x, c_axis)
    xhat = (x.float() - m.reshape(bshape)) * inv.reshape(bshape)
    z = xhat * scale.reshape(bshape).float() + bias.reshape(bshape).float()
    if residual is not None:
        z = z + residual.float()
    y = torch.relu(z) if act == "relu" else z
    return y.to(x.dtype), xhat, z


class _BnActCore(torch.autograd.Function):
    """y = act((x - m) * inv * scale + bias [+ residual]) with m and inv
    given (the batch stats, without gradient). The backward is the
    reference's closed form, which owns the whole training-mode dx
    (the stats' dependence on x included)."""

    @staticmethod
    def forward(ctx, x, scale, bias, m, inv, residual, act, c_axis):
        ctx.save_for_backward(x, scale, bias, m, inv, residual)
        ctx.act, ctx.c_axis = act, c_axis
        return _bn_act_math(act, c_axis, x, scale, bias, m, inv,
                            residual)[0]

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, m, inv, residual = ctx.saved_tensors
        c_axis = ctx.c_axis
        bshape = _bshape(x, c_axis)
        axes = tuple(a for a in range(x.dim()) if a != c_axis)
        n = float(math.prod(x.shape[a] for a in axes))
        _, xhat, z = _bn_act_math(ctx.act, c_axis, x, scale, bias, m, inv,
                                  residual)
        dy32 = dy.float()
        dz = torch.where(z > 0.0, dy32, 0.0) if ctx.act == "relu" else dy32
        dbias = dz.sum(dim=axes)
        dscale = (dz * xhat).sum(dim=axes)
        dx = (scale.float() * inv).reshape(bshape) * (
            dz - dbias.reshape(bshape) / n
            - xhat * dscale.reshape(bshape) / n)
        dres = None if residual is None else dz.to(residual.dtype)
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(bias.dtype), None, None, dres, None, None)


def fused_bn_act(x, scale, bias, mean, variance, residual=None, *,
                 momentum=0.9, epsilon=1e-5, act="relu", is_test=False,
                 data_format="NCHW", use_global_stats=False):
    """act(batch_norm(x) [+ residual]) and the new running stats.
    Training goes through `_BnActCore`; eval normalises with the running
    stats (plain autograd: nothing to save)."""
    c_axis = 1 if data_format == "NCHW" else x.dim() - 1
    if is_test or use_global_stats:
        inv = torch.rsqrt(variance + epsilon)
        y, _, _ = _bn_act_math(act, c_axis, x, scale, bias, mean, inv,
                               residual)
        return y, (mean, variance)
    with torch.no_grad():
        use_mean, use_var = _stats(x, c_axis)
        inv = torch.rsqrt(use_var + epsilon)
    y = _BnActCore.apply(x, scale, bias, use_mean, inv, residual, act,
                         c_axis)
    new_mean = momentum * mean + (1 - momentum) * use_mean
    new_var = momentum * variance + (1 - momentum) * use_var
    return y, (new_mean.detach(), new_var.detach())
