"""Neural-network ops (counterpart of paddle_tpu/ops/nn_ops.py: convs,
pools, norms, resize and layout ops).

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

The other convs (1-D, 3-D, transposed) are torch's convolutions under
the reference's padding rules; a transposed conv is torch's with no
padding, from which the window that the reference's conv over the
dilated input produces is cut (any lo / hi padding; 'SAME' / 'VALID'
at stride 1).
The pools with indices pad with -inf and return flat indices into the
unpadded input map, the first maximum of a window winning. `interpolate`
is the arithmetic of ``jax.image.resize``, which the reference calls
whatever ``align_corners`` says: half-pixel centres, a triangle or Keys
cubic kernel widened by the scale when downsampling, and nearest as
``floor((i + 0.5) * in / out)``.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as tF

__all__ = ["conv2d", "conv1d", "conv3d", "conv_transpose", "pad_nd",
           "pool2d", "pool_nd", "adaptive_pool_nd", "max_pool_with_index",
           "adaptive_max_pool_with_index",
           "batch_norm", "batch_norm_apply", "fused_bn_act",
           "adaptive_bounds", "instance_norm", "group_norm", "rms_norm",
           "local_response_norm", "l2_normalize", "interpolate", "pad",
           "pixel_shuffle", "unfold", "temporal_shift"]


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


def pad_nd(x, pads, value=0.0):
    """Pad (or, for negative amounts, crop, as ``lax.pad`` does) the
    trailing ``len(pads)`` dims of `x` by ``[(lo, hi), ...]``, the first
    pair on the first of them."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return tF.pad(x, flat, value=value) if any(flat) else x


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
    out = tF.conv2d(pad_nd(x, pad), weight, stride=strides,
                    dilation=dilations, groups=groups)
    return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out


# -- pooling ---------------------------------------------------------------


def pool_nd(x, nd, *, ksize, stride=None, padding=0, ceil_mode=False,
            pooling_type="max", exclusive=True):
    """Max / average pooling over the trailing `nd` (2 or 3) dims of NC...
    `x`, as the reference's ``reduce_window`` with its pads: max pads
    with -inf (the dtype's least integer), ``ceil_mode`` extends the hi
    pads so ceil-division windows are produced, and an exclusive average
    divides by the real elements of each window when any pad is not 0."""
    ks = _pair(ksize, nd)
    st = ks if stride is None else _pair(stride, nd)
    if isinstance(padding, str):
        pads = _same_pads(x.shape[2:], ks, st, (1,) * nd) \
            if padding.upper() == "SAME" else [(0, 0)] * nd
    else:
        pads = list(_conv_padding(padding, nd, st, (1,) * nd, ks))
    if ceil_mode:
        for i, (dim, k, s) in enumerate(zip(x.shape[2:], ks, st)):
            lo, hi = pads[i]
            rem = (dim + lo + hi - k) % s
            if rem:
                pads[i] = (lo, hi + (s - rem))
    if pooling_type == "max":
        init = -math.inf if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        fn = tF.max_pool2d if nd == 2 else tF.max_pool3d
        return fn(pad_nd(x, pads, init), ks, st)
    avg = tF.avg_pool2d if nd == 2 else tF.avg_pool3d
    summed = avg(pad_nd(x, pads), ks, st, divisor_override=1)
    if exclusive and any(p != (0, 0) for p in pads):
        return summed / avg(pad_nd(torch.ones_like(x), pads), ks, st,
                            divisor_override=1)
    return summed / math.prod(ks)


def pool2d(x, *, ksize, stride=None, padding=0, ceil_mode=False,
           pooling_type="max", exclusive=True, global_pooling=False,
           adaptive=False, data_format="NCHW"):
    if global_pooling:
        axes = (2, 3) if data_format == "NCHW" else (1, 2)
        if pooling_type == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.mean(dim=axes, keepdim=True)
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    if adaptive:
        out = adaptive_pool_nd(x, ksize, pooling_type)
    else:
        out = pool_nd(x, 2, ksize=ksize, stride=stride, padding=padding,
                      ceil_mode=ceil_mode, pooling_type=pooling_type,
                      exclusive=exclusive)
    return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out


def adaptive_bounds(i, size, bins):
    """Paddle adaptive-pool bin i over `size` elements in `bins` cells:
    [floor(i*size/bins), ceil((i+1)*size/bins))."""
    return (i * size) // bins, -(-((i + 1) * size) // bins)


def adaptive_pool_nd(x, output_size, mode):
    """Adaptive max / average pooling of the trailing dims of NC... `x`:
    the uniform pool when every dim divides, else one reduction a cell
    over paddle's overlapping bins (start floor, end ceil)."""
    sp = tuple(x.shape[2:])
    os_ = _pair(output_size, len(sp))
    if all(s % o == 0 for s, o in zip(sp, os_)):
        ks = tuple(s // o for s, o in zip(sp, os_))
        return pool_nd(x, len(sp), ksize=ks, stride=ks, pooling_type=mode)
    axes = tuple(range(2, x.dim()))
    cells = []
    for cell in itertools.product(*(range(o) for o in os_)):
        win = x[(slice(None), slice(None)) + tuple(
            slice(*adaptive_bounds(c, s, o))
            for c, s, o in zip(cell, sp, os_))]
        cells.append(win.amax(dim=axes) if mode == "max"
                     else win.mean(dim=axes))
    return torch.stack(cells, -1).reshape(*x.shape[:2], *os_)


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


# -- 1-D, 3-D and transposed convs -------------------------------------------


def _window(x, dim, start, n):
    """`n` elements of `x` along `dim` from `start`, zero beyond its
    ends (start may be negative)."""
    lo, hi = max(0, -start), max(0, start + n - x.shape[dim])
    if lo or hi:
        pads = [0, 0] * (x.dim() - 1 - dim) + [lo, hi]
        x = tF.pad(x, pads)
    return x.narrow(dim, start + lo, n)


def _pads_nd(x, pad, ksizes, strides, dilations):
    """[(lo, hi), ...] for the trailing len(ksizes) dims of NC... `x`."""
    if isinstance(pad, str):
        return [(0, 0)] * len(ksizes) if pad == "VALID" else _same_pads(
            x.shape[2:], ksizes, strides, dilations)
    return pad


def conv1d(x, weight, *, stride=1, padding=0, dilation=1, groups=1):
    """The reference's conv1d: conv2d over ``x[:, :, None, :]`` with
    padding on L only (symmetric), NCL whatever the data format."""
    s = stride if isinstance(stride, int) else stride[0]
    d = dilation if isinstance(dilation, int) else dilation[0]
    k = weight.shape[-1]
    if isinstance(padding, str):
        pad = _pads_nd(x, padding.upper(), (k,), (s,), (d,))
    else:
        pv = padding if isinstance(padding, int) else padding[0]
        pad = [(pv, pv)]
    return tF.conv1d(pad_nd(x, pad), weight, stride=s, dilation=d,
                     groups=groups)


def conv3d(x, weight, *, stride=1, padding=0, dilation=1, groups=1):
    """NCDHW (the reference's layout whatever the data format)."""
    strides, dilations = _pair(stride, 3), _pair(dilation, 3)
    ks = tuple(weight.shape[2:])
    pad = _pads_nd(x, _conv_padding(padding, 3, strides, dilations, ks),
                   ks, strides, dilations)
    return tF.conv3d(pad_nd(x, pad), weight, stride=strides,
                     dilation=dilations, groups=groups)


def conv_transpose(x, weight, spatial, *, stride=1, padding=0,
                   output_padding=0, dilation=1, groups=1,
                   data_format="NCHW"):
    """The reference's `_conv_transpose`: a conv of the stride-dilated
    input with the flipped, regrouped ``[C_in, C_out / groups, *k]``
    weight under padding ``d (k - 1) - lo`` / ``d (k - 1) - hi +
    output_padding`` (lax's 'SAME' / 'VALID', which it takes at stride 1
    only), that is torch's unpadded transposed conv cut to
    ``[lo, lo + n)``."""
    strides = _pair(stride, spatial)
    dilations = _pair(dilation, spatial)
    opad = _pair(output_padding, spatial)
    ks = tuple(weight.shape[2:])
    spans = [d * (k - 1) for d, k in zip(dilations, ks)]
    channel_last = data_format in ("NHWC", "NDHWC", "NLC")
    if channel_last:
        x = x.movedim(-1, 1)
    if isinstance(padding, str):
        if any(st != 1 for st in strides):
            raise ValueError("conv_transpose: string padding needs stride "
                             "1, as the reference's lax op does")
        lax_pads = [(0, 0)] * spatial if padding.upper() == "VALID" else \
            [(t // 2, t - t // 2) for t in spans]
        pad = [(sp - a, sp - b) for sp, (a, b) in zip(spans, lax_pads)]
        opad = (0,) * spatial
    else:
        pad = _conv_padding(padding, spatial, strides, dilations, ks,
                            channel_last=channel_last)
    fn = (tF.conv_transpose1d, tF.conv_transpose2d,
          tF.conv_transpose3d)[spatial - 1]
    out = fn(x, weight, stride=strides, groups=groups, dilation=dilations)
    for i, ((lo, hi), size) in enumerate(zip(pad, x.shape[2:])):
        n = (size - 1) * strides[i] + spans[i] + 1 - lo - hi + opad[i]
        out = _window(out, 2 + i, lo, n)
    return out.movedim(1, -1) if channel_last else out


# -- pooling with indices, n-d pooling ---------------------------------------


def max_pool_with_index(x, ks, st, pd):
    """Max pool over the trailing dims of NC... `x` with -inf padding and
    the argmax as a flat int32 index into the unpadded spatial map (the
    reference's `max_pool_with_index_nd`)."""
    nd = x.dim() - 2
    maxf = tF.max_pool2d if nd == 2 else tF.max_pool3d
    xp = pad_nd(x, [(p, p) for p in pd], -math.inf)
    out, idx = maxf(xp, ks, st, return_indices=True)
    psp = xp.shape[2:]
    coords, rem = [], idx
    for d in reversed(range(nd)):
        coords.append(rem % psp[d] - pd[d])
        rem = rem // psp[d]
    coords.reverse()
    flat, mult = 0, 1
    for d in reversed(range(nd)):
        flat = flat + coords[d] * mult
        mult *= x.shape[2 + d]
    flat = flat.to(torch.int32)
    # values gathered from the input by the index, as the reference does
    vals = torch.gather(x.flatten(2), 2, flat.long().flatten(2)).reshape(
        out.shape)
    return vals, flat


def adaptive_max_pool_with_index(x, os_):
    """Adaptive max pool with indices over the trailing dims: the
    uniform pool when every dim divides, else one window per cell over
    paddle's [floor(i S / o), ceil((i + 1) S / o)) bins."""
    n, c, *sp = x.shape
    nd = len(sp)
    if all(sp[d] % os_[d] == 0 for d in range(nd)):
        ks = tuple(sp[d] // os_[d] for d in range(nd))
        return max_pool_with_index(x, ks, ks, (0,) * nd)
    vals, idxs = [], []
    for cell in itertools.product(*[range(o) for o in os_]):
        bounds = [adaptive_bounds(cell[d], sp[d], os_[d]) for d in range(nd)]
        win = x[(slice(None), slice(None))
                + tuple(slice(s, e) for s, e in bounds)]
        wshape = [e - s for s, e in bounds]
        flat = win.reshape(n, c, -1)
        v, rel = flat.max(dim=2)
        pos, rem, mult = 0, rel, 1
        for d in reversed(range(nd)):
            pos = pos + (bounds[d][0] + rem % wshape[d]) * mult
            rem = rem // wshape[d]
            mult *= sp[d]
        vals.append(v)
        idxs.append(pos.to(torch.int32))
    return (torch.stack(vals, -1).reshape(n, c, *os_),
            torch.stack(idxs, -1).reshape(n, c, *os_))


# -- normalisation ---------------------------------------------------------


def _f32(x):
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def instance_norm(x, scale=None, bias=None, *, epsilon=1e-5):
    """Per-sample, per-channel stats over the spatial dims in f32, one
    pass (``E[x^2] - E[x]^2`` clamped at 0)."""
    axes = tuple(range(2, x.dim()))
    x32 = _f32(x)
    mean = x32.mean(dim=axes, keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=axes, keepdim=True)
                          - mean * mean, 0.0)
    y = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    bshape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


def group_norm(x, scale=None, bias=None, *, epsilon=1e-5, groups=1):
    """Channels in `groups` (dim 1, whatever the data format, as the
    reference reads it)."""
    n, c = x.shape[0], x.shape[1]
    xg = _f32(x.reshape((n, groups, c // groups) + tuple(x.shape[2:])))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = torch.clamp_min((xg * xg).mean(dim=axes, keepdim=True)
                          - mean * mean, 0.0)
    y = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape).to(
        x.dtype)
    bshape = [1, c] + [1] * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


def rms_norm(x, scale=None, *, epsilon=1e-6):
    x32 = _f32(x)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return y * scale if scale is not None else y


def local_response_norm(x, *, size, alpha=1e-4, beta=0.75, k=1.0):
    """``x / (k + alpha * sum of x^2 over size channels) ** beta`` (alpha
    not divided by size, as in the reference)."""
    half = size // 2
    padded = tF.pad(x * x, [0, 0] * (x.dim() - 2) + [half, size - half - 1])
    acc = sum(padded[:, i:i + x.shape[1]] for i in range(size))
    return x / (k + alpha * acc) ** beta


def l2_normalize(x, *, axis=-1, epsilon=1e-12):
    norm = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
    return x / torch.clamp_min(norm, epsilon)


# -- resize ----------------------------------------------------------------


def _triangle(t):
    return torch.clamp_min(1 - t.abs(), 0.0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _resize_weights(m, n, kernel, dtype, device):
    """``jax.image``'s ``compute_weight_mat`` (antialias on, translation
    0) for input size m and output size n: [m, n]."""
    scale = n / m
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    t = (sample[None, :] - torch.arange(m, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kscale
    w = kernel(t)
    tot = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(tot.abs() > eps,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def interpolate(x, *, size=None, scale_factor=None, mode="nearest",
                data_format="NCHW"):
    """The reference's ``jax.image.resize`` of the spatial dims."""
    nsp = x.dim() - 2
    channel_last = data_format in ("NWC", "NHWC", "NDHWC")
    axes = tuple(range(1, 1 + nsp)) if channel_last \
        else tuple(range(2, 2 + nsp))
    in_sizes = [x.shape[a] for a in axes]
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nsp
        size = [int(s * f) for s, f in zip(in_sizes, sf)]
    kernels = {"linear": _triangle, "bilinear": _triangle,
               "trilinear": _triangle, "area": _triangle,
               "bicubic": _keys_cubic}
    if mode != "nearest" and mode not in kernels:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    if not x.is_floating_point() and mode != "nearest":
        x = x.float()
    for a, m, n in zip(axes, in_sizes, size):
        n = int(n)
        if m == n:
            continue
        if mode == "nearest":
            off = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = x.index_select(a, off)
            continue
        w = _resize_weights(m, n, kernels[mode], x.dtype, x.device)
        x = torch.tensordot(x.movedim(a, -1), w, dims=1).movedim(-1, a)
    return x


# -- layout ----------------------------------------------------------------


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    # reflect about the edges without repeating them (numpy 'reflect')
    period = 2 * (n - 1)
    r = i.abs() % period if period else torch.zeros_like(i)
    return torch.where(r > n - 1, period - r, r)


def pad(x, *, paddings, mode="constant", value=0.0):
    """paddings: a ``[lo, hi]`` pair per dim (flat, 2 * ndim entries);
    non-constant modes gather indices, so any dim may be padded."""
    pairs = [(int(paddings[2 * i]), int(paddings[2 * i + 1]))
             for i in range(x.dim())]
    if mode == "constant":
        return pad_nd(x, pairs, value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def pixel_shuffle(x, *, upscale_factor):
    r = upscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def unfold(x, *, kernel_sizes, strides=1, paddings=0, dilations=1):
    ph, pw = _pair(paddings)[:2]
    return tF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     padding=(ph, pw), stride=_pair(strides))


def temporal_shift(x, *, seg_num, shift_ratio=0.25):
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x5[:, 1:, :fold], torch.zeros_like(x5[:, :1, :fold])],
                     1)
    right = torch.cat([torch.zeros_like(x5[:, :1, fold:2 * fold]),
                       x5[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, x5[:, :, 2 * fold:]], 2).reshape(
        nt, c, h, w)
