"""Convolution with fused batch-norm epilogues (counterpart of
paddle_tpu/ops/fused_conv.py), on one stride-1 VALID NHWC kernel:

    B10 `_conv_kernel`   conv of a lowered plane, with the none, moments
                         or affine(+residual, ReLU / identity) epilogue

CUDA tensors run the hand-written kernel of ``csrc/fused_conv.cu``; CPU
tensors run its plain version `_conv_plain`. Around it, in PyTorch, as
in the reference:
- `_lower` turns a conv into that kernel's input: the pad (negative
  amounts crop, as ``lax.pad`` does), stride 2 as space-to-depth
  parity planes with the weight regrouped (the folding of
  ``fold_conv7_stem``), NCHW to NHWC, and in bf16 and float16 the
  channels padded to a multiple of 8 for the tensor-core kernel; `_live_chunks` lists,
  from the plan alone, the 64-row chunks of the lowered weight that
  kernel walks (the stride-2 lowering leaves some all zero);
- `_ConvCore` (conv, optionally with the BN moments) and `_ConvAffine`
  (the eval form: the BN folded to ``g, b``) are autograd Functions with
  the reference's backwards. They save the ORIGINAL NCHW ``x`` and
  ``w`` and lower them again in the backward. dx is `_input_grad`:
  each input-parity plane is a dense stride-1 conv of dz through the
  same kernel; dw is torch's convolution weight gradient (the reference
  transposes its lax conv outside any Pallas kernel).

What the moments are taken of: the kernel sums the UNROUNDED float32
accumulator, and so does `_conv_plain`, which convolves in float32 from
the (possibly bf16 or float16) operands, takes the moments there and
casts z once. The reference's lax fallback (``_fwd``) sums z after it
is rounded to x's dtype: in float32 the two agree, in 16 bits they do
not. A bf16 and a float16 CUDA tensor each launch the kernel's own
instantiation in that dtype (one template, ``wgmma`` bf16 or f16).

`_plan` keeps the reference's eligibility without its TPU limits (the
VMEM budget, the 128-wide O tiles, the tap cap): the kernel masks its own
ragged edges, so every conv `_supported` accepts reaches it. On CUDA an
eligible conv launches B10 or raises; there is no probe and no silent
fallback. ``FLAGS_use_pallas_conv`` (default on) keeps its name: off,
``conv2d`` takes torch's convolution and ``fused_conv2d_bn_act``
composes it with ``fused_bn_act`` (the reference's lax path).
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tF

from .. import amp
from ..framework.flags import flag
from . import _launch
from .nn_ops import _BnActCore, _conv_padding, _pair, _same_pads, pad_nd

__all__ = ["fused_conv2d_bn_act", "conv2d_maybe_pallas", "LAUNCHES"]

LAUNCHES = 0


def _use_pallas_conv():
    return flag("FLAGS_use_pallas_conv")


# ---------------------------------------------------------------------------
# plan: eligibility + geometry of the stride-1 lowering
# ---------------------------------------------------------------------------


class _Plan:
    __slots__ = ("s", "pads", "ho", "wo", "kkh", "kkw", "c", "kh", "kw")

    def __init__(self, s, pads, ho, wo, kkh, kkw, c, kh, kw):
        self.s, self.pads = s, pads
        self.ho, self.wo = ho, wo
        self.kkh, self.kkw = kkh, kkw
        self.c, self.kh, self.kw = c, kh, kw


def _plan(xs, ws, strides, pads):
    """The plan of the stride-1 lowering, or None when the conv has no
    such form (the caller keeps the composed path). Assumes the caller
    verified NCHW / groups=1 / dilation=1."""
    if strides[0] != strides[1] or strides[0] not in (1, 2):
        return None
    s = strides[0]
    n, c, h, w = xs
    o, ci, kh, kw = ws
    if n < 1:
        return None
    ho = (h + pads[0][0] + pads[0][1] - kh) // s + 1
    wo = (w + pads[1][0] + pads[1][1] - kw) // s + 1
    if ho <= 0 or wo <= 0:
        return None
    return _Plan(s, (tuple(pads[0]), tuple(pads[1])), ho, wo,
                 -(-kh // s), -(-kw // s), c, kh, kw)


def _lower(x, w, plan):
    """(xp [N, Hp, Wp, Ce] pre-padded NHWC, wk [Kkh*Kkw, Ce, O]) of the
    equivalent stride-1 VALID conv.

    stride 2: parity planes xp_a[i] = xpad[2i+a] become channels and the
    weight regroups as w'[o,(a,b,c),q,r] = w[o,c,2q+a,2r+b] (zero where
    2q+a >= k). bf16 and f16 (the tensor-core kernel's operands): Ce is
    padded
    to a multiple of 8 with zero channels in xp and zero rows in wk, so
    each 8-channel unit of K lies in one tap."""
    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    (plh, phh), (plw, phw) = plan.pads
    if plan.s == 1:
        xp = pad_nd(x, plan.pads)
        wk = w
    else:
        # one extra zero row/col parity-pads odd extents so both planes
        # have equal length (the zeros land on taps past the support)
        eh = (h + plh + phh) % 2
        ew = (wd + plw + phw) % 2
        xpad = pad_nd(x, ((plh, phh + eh), (plw, phw + ew)))
        al, bl = range(min(2, kh)), range(min(2, kw))
        xp = torch.cat([xpad[:, :, a::2, b::2] for a in al for b in bl], 1)
        wpad = pad_nd(w, ((0, 2 * plan.kkh - kh), (0, 2 * plan.kkw - kw)))
        wk = torch.cat([wpad[:, :, a::2, b::2] for a in al for b in bl], 1)
    # exactly the rows/cols the VALID conv reads (even-k lowering can
    # leave one unused trailing plane row)
    hp, wp = plan.ho + plan.kkh - 1, plan.wo + plan.kkw - 1
    assert xp.shape[2] >= hp and xp.shape[3] >= wp, (xp.shape, hp, wp)
    xp = xp[:, :, :hp, :wp]
    extra = -wk.shape[1] % 8 if x.dtype != torch.float32 else 0
    if extra:
        xp = tF.pad(xp, (0, 0, 0, 0, 0, extra))
        wk = tF.pad(wk, (0, 0, 0, 0, 0, extra))
    xp = xp.permute(0, 2, 3, 1).contiguous()
    ce = wk.shape[1]
    wk = wk.permute(2, 3, 1, 0).reshape(plan.kkh * plan.kkw, ce, o)
    return xp, wk.contiguous()


# K rows of one chunk of the 16-bit kernel's walk (kBK in
# csrc/fused_conv.cu) and the most chunks its list holds (kMaxLive: K
# up to 32768, ResNet-50's longest is 4608)
_CHUNK_K = 64
_MAX_LIVE = 512


def _live_rows(plan, ce):
    """Which rows of the lowered wk [T * Ce] can be nonzero: row
    t * Ce + ch, tap t = q * Kkw + r, reads w[o, ch, q, r] at stride 1
    and w[o, ch % C, 2q+a, 2r+b] of parity plane (a, b) = divmod(ch // C,
    planes across) at stride 2; taps past the kernel's support and the
    padding channels past the planes are zero."""
    s, c, kh, kw = plan.s, plan.c, plan.kh, plan.kw
    nb = min(s, kw)
    planes = min(s, kh) * nb
    rows = []
    for q in range(plan.kkh):
        for r in range(plan.kkw):
            for ch in range(ce):
                p = ch // c
                a, b = divmod(p, nb)
                rows.append(p < planes and s * q + a < kh and s * r + b < kw)
    return rows


_LIVE = {}


def _live_chunks(plan, ce):
    """The 64-row chunks of the lowered wk that hold a live row (see
    `_live_rows`), in order, as the ctypes array of chunk indices the
    16-bit kernel walks. Raises past `_MAX_LIVE` chunks. Cached by the
    geometry: it depends on no data."""
    key = (plan.s, plan.c, plan.kh, plan.kw, ce)
    if key not in _LIVE:
        rows = _live_rows(plan, ce)
        live = [i for i in range(-(-len(rows) // _CHUNK_K))
                if any(rows[i * _CHUNK_K:(i + 1) * _CHUNK_K])]
        if len(live) > _MAX_LIVE:
            raise ValueError(f"fused conv: {len(live)} live K chunks of "
                             f"{_CHUNK_K}, the 16-bit kernel takes at most "
                             f"{_MAX_LIVE}")
        _LIVE[key] = (ctypes.c_ushort * len(live))(*live)
    return _LIVE[key]


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------

# output pixels of one M tile, as kBM (bf16, f16) and kFM (f32) in
# csrc/fused_conv.cu: the moments epilogue writes one partial a tile and
# channel
_TILE_M = {torch.bfloat16: 128, torch.float16: 128, torch.float32: 64}


def _conv_plain(xp, wk, plan, g=None, b=None, res=None, act="identity",
                moments=False):
    """B10's plain version: the stride-1 VALID conv of the lowered plane
    in float32 (TF32 off), the epilogue on the unrounded result, one cast
    to xp's dtype. Returns [y] or [y, sum, sum_sq] (NHWC y, moments f32
    [O])."""
    kk, ce, o = wk.shape
    w4 = wk.float().reshape(plan.kkh, plan.kkw, ce, o).permute(3, 2, 0, 1)
    acc = tF.conv2d(xp.float().permute(0, 3, 1, 2), w4).permute(0, 2, 3, 1)
    z = acc
    if g is not None:
        z = z * g.float() + b.float()
    if res is not None:
        z = z + res.float()
    if act == "relu":
        z = torch.relu(z)
    outs = [z.to(xp.dtype)]
    if moments:
        outs += [acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2))]
    return outs


def _conv_kernel(xp, wk, plan, g=None, b=None, res=None, act="identity",
                 moments=False):
    """B10 on the card; the same contract as `_conv_plain` (bf16 and f16:
    Ce a multiple of 8, as `_lower` pads it)."""
    global LAUNCHES
    if xp.dtype not in _launch._DTYPE_CODES:
        raise TypeError(f"fused conv: operands must be float32, bfloat16 "
                        f"or float16 on CUDA, got {xp.dtype}")
    if wk.dtype != xp.dtype or (res is not None and res.dtype != xp.dtype):
        raise TypeError("fused conv: xp, wk and the residual must share "
                        "one dtype")
    n, hp, wp, ce = xp.shape
    kk, wce, o = wk.shape
    if (kk != plan.kkh * plan.kkw or wce != ce
            or hp != plan.ho + plan.kkh - 1 or wp != plan.wo + plan.kkw - 1):
        raise ValueError(f"fused conv: xp {tuple(xp.shape)} and wk "
                         f"{tuple(wk.shape)} do not match the plan")
    if res is not None and tuple(res.shape) != (n, plan.ho, plan.wo, o):
        raise ValueError(f"fused conv: residual {tuple(res.shape)} is not "
                         f"{(n, plan.ho, plan.wo, o)}")
    if act not in ("relu", "identity"):
        raise ValueError(f"fused conv: act must be relu or identity, got "
                         f"{act!r}")
    dev = xp.device
    _launch.same_device("fused conv", xp, wk, *(t for t in (g, b, res)
                                                if t is not None))
    xp, wk = _launch.aligned(xp), _launch.aligned(wk)
    res = _launch.aligned(res) if res is not None else None
    dtype = _launch.dtype_code(xp)
    live, ldw = None, o
    if dtype:
        if ce % 8:
            raise ValueError(f"fused conv: {xp.dtype} Ce {ce} is not a "
                             f"multiple of 8 (lower the conv with "
                             f"`_lower`)")
        live = _live_chunks(plan, ce)
        # 16-byte weight rows: zero columns up to a multiple of 8
        ldw = o + (-o % 8)
        if ldw != o:
            wk = _launch.aligned(tF.pad(wk, (0, ldw - o)))
    m = n * plan.ho * plan.wo
    y = torch.empty((n, plan.ho, plan.wo, o), dtype=xp.dtype, device=dev)
    msum = msq = None
    if moments:
        # the sum and sum-of-squares partials, a row of M tiles a
        # channel, in one tensor: one reduction over its last dim sums
        # both
        tiles = -(-m // _TILE_M[xp.dtype])
        parts = torch.empty((2, o, tiles), dtype=torch.float32, device=dev)
        msum, msq = parts[0], parts[1]
    if g is not None:
        g = g.float().contiguous()
        b = b.float().contiguous()
    P, I = _launch._P, _launch._I
    lib, fn = _launch.bind("fused_conv", "fused_conv",
                           [I, I, I, P, P, P, P, P, P, P, P,
                            I, I, I, I, I, I, I, I, P, I, I, P])
    epi = 1 if moments else (2 if g is not None else 0)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    _launch.launch(lib, fn, "fused_conv", dev, dtype, epi,
                   int(act == "relu"), xp.data_ptr(), wk.data_ptr(),
                   ptr(g), ptr(b), ptr(res), y.data_ptr(), ptr(msum),
                   ptr(msq), n, hp, wp, ce, plan.kkh, plan.kkw, o, ldw,
                   live, len(live) if live is not None else 0)
    LAUNCHES += 1
    if moments:
        return [y, *parts.sum(2)]
    return [y]


def _occupancy(tile_n, dtype=torch.bfloat16):
    """What the 16-bit kernel launches in `dtype` for its tile of
    `tile_n` (64, 128 or 256) outputs on the current card
    (`_launch.occupancy`; a report, the op never calls it)."""
    return _launch.occupancy("fused_conv", "fused_conv_occupancy", tile_n,
                             _launch._DTYPE_CODES[dtype])


def _fwd(x, w, s, pads, *, g=None, b=None, res=None, act="identity",
         moments=False):
    """Fused conv forward, NCHW in and out: y, or (y, sum, sum_sq) with
    `moments`. The kernel (CUDA) or its plain version (CPU) on the
    lowered plane."""
    assert not (moments and (g is not None or res is not None))
    plan = _plan(x.shape, w.shape, (s, s), pads)
    if plan is None:
        raise ValueError(f"fused conv: no output for x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, stride {s}, pads {pads}")
    xp, wk = _lower(x, w, plan)
    rs = res.permute(0, 2, 3, 1) if res is not None else None
    run = _conv_kernel if _launch.route(xp) == "kernel" else _conv_plain
    outs = run(xp, wk, plan, g=g, b=b, res=rs, act=act, moments=moments)
    y = outs[0].permute(0, 3, 1, 2)
    return (y, outs[1], outs[2]) if moments else y


# ---------------------------------------------------------------------------
# backward: transposed-conv dx by parity decomposition
# ---------------------------------------------------------------------------


def _taps_1d(k, s, a, pad_lo):
    """1-D taps of the transposed conv feeding dx rows u = a (mod s):
    kernel positions kh with kh = (a+pad_lo) mod s, whose shifts
    m = (kh-a-pad_lo)/s are consecutive integers — ordered by descending
    m the sum dxp[i] = sum dz[i-m]·w[kh] is a plain stride-1 correlation
    with low padding m_max. Returns (taps, m_max) or None (no taps: that
    parity plane receives no gradient)."""
    ks = [kh for kh in range(k) if (kh - a - pad_lo) % s == 0]
    if not ks:
        return None
    return list(reversed(ks)), (ks[-1] - a - pad_lo) // s


def _input_grad(dz, w, cfg, x_shape):
    """dx as stride-1 transposed convs routed back through `_fwd` (the
    same kernel): each input-parity plane gets its own dense
    small-kernel conv of dz (its pads may be negative: a crop) and the
    planes interleave back."""
    s, plh, phh, plw, phw = cfg
    n, c, h, wd = x_shape
    kh, kw = w.shape[2], w.shape[3]
    ho, wo = dz.shape[2], dz.shape[3]

    def plane(a, b, ha, wa):
        th, tw = _taps_1d(kh, s, a, plh), _taps_1d(kw, s, b, plw)
        if th is None or tw is None:
            return None
        rows, mh = th
        cols, mw = tw
        wab = w[:, :, rows][:, :, :, cols].transpose(0, 1)
        pads = ((mh, ha - ho - mh + len(rows) - 1),
                (mw, wa - wo - mw + len(cols) - 1))
        return _fwd(dz, wab, 1, pads)

    if s == 1:
        out = plane(0, 0, h, wd)
        return out if out is not None else dz.new_zeros(x_shape)
    dx = dz.new_zeros(x_shape)
    for a in range(s):
        ha = (h - a + s - 1) // s
        for b in range(s):
            wa = (wd - b + s - 1) // s
            if ha <= 0 or wa <= 0:
                continue
            p = plane(a, b, ha, wa)
            if p is not None:
                dx[:, :, a::s, b::s] = p
    return dx


def _weight_grad(x, dz, w, cfg):
    """dw of the conv: torch's convolution weight gradient (the
    reference transposes its lax conv, outside any Pallas kernel)."""
    s, plh, phh, plw, phw = cfg
    if plh == phh and plw == phw:
        pad = [plh, plw]
    else:
        x, pad = pad_nd(x, ((plh, phh), (plw, phw))), [0, 0]
    _, dw, _ = torch.ops.aten.convolution_backward(
        dz, x, w, None, [s, s], pad, [1, 1], False, [0, 0], 1,
        [False, True, False])
    return dw


def _conv_grads(x, w, dz, cfg, need_dx=True, need_dw=True):
    dz, wx = dz.to(x.dtype), w.to(x.dtype)
    dx = _input_grad(dz, wx, cfg, x.shape).to(x.dtype) if need_dx else None
    dw = _weight_grad(x, dz, wx, cfg).to(w.dtype) if need_dw else None
    return dx, dw


def _pads(cfg):
    return ((cfg[1], cfg[2]), (cfg[3], cfg[4]))


class _ConvCore(torch.autograd.Function):
    """Conv (optionally + moments) with the transposed-conv backward;
    cfg = (s, plh, phh, plw, phw). The moments carry no gradient: every
    caller feeds them to `_BnActCore`, whose VJP owns the stats' term."""

    @staticmethod
    def forward(ctx, x, w, cfg, moments):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        out = _fwd(x, w, cfg[0], _pads(cfg), moments=moments)
        if moments:
            ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, dz, *_moment_grads):
        x, w = ctx.saved_tensors
        dx, dw = _conv_grads(x, w, dz, ctx.cfg, *ctx.needs_input_grad[:2])
        return dx, dw, None, None


class _ConvAffine(torch.autograd.Function):
    """Eval-fused y = act(conv(x, w) * g + b [+ res]): the fully folded
    BN epilogue (g = scale * rsqrt(var + eps), b = bias - mean * g)."""

    @staticmethod
    def forward(ctx, x, w, g, b, res, cfg, act):
        ctx.save_for_backward(x, w, g, b, res)
        ctx.cfg, ctx.act = cfg, act
        return _fwd(x, w, cfg[0], _pads(cfg), g=g, b=b, res=res, act=act)

    @staticmethod
    def backward(ctx, dy):
        x, w, g, b, res = ctx.saved_tensors
        cfg = ctx.cfg
        # recompute z (one more conv) instead of saving it
        z32 = _fwd(x, w, cfg[0], _pads(cfg)).float()
        u = z32 * g.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)
        if res is not None:
            u = u + res.float()
        dy32 = dy.float()
        du = torch.where(u > 0.0, dy32, 0.0) if ctx.act == "relu" else dy32
        dg = (du * z32).sum(dim=(0, 2, 3))
        db = du.sum(dim=(0, 2, 3))
        dx, dw = _conv_grads(x, w, du * g.reshape(1, -1, 1, 1), cfg,
                             *ctx.needs_input_grad[:2])
        dres = du.to(res.dtype) if res is not None else None
        return dx, dw, dg.to(g.dtype), db.to(b.dtype), dres, None, None


# ---------------------------------------------------------------------------
# op surface
# ---------------------------------------------------------------------------


def _explicit_pads(pad, xs, ks, strides):
    if isinstance(pad, str):
        if pad == "VALID":
            return ((0, 0), (0, 0))
        return tuple(_same_pads(xs[2:], ks, strides))
    return (tuple(pad[0]), tuple(pad[1]))


def _supported(x, w, strides, dilations, groups, data_format):
    return (data_format == "NCHW" and groups == 1
            and dilations == (1, 1) and strides[0] == strides[1]
            and strides[0] in (1, 2) and x.dim() == 4
            and x.is_floating_point() and x.dtype == w.dtype)


def conv2d_maybe_pallas(x, w, strides, pad, dilations, groups,
                        data_format):
    """Hook for nn_ops.conv2d: a plain conv through `_ConvCore` (B10 and
    its transposed-conv VJP) when the flag and the plan allow; None keeps
    the caller on torch's convolution."""
    if not _use_pallas_conv():
        return None
    if not _supported(x, w, strides, dilations, groups, data_format):
        return None
    pads = _explicit_pads(pad, x.shape, (w.shape[2], w.shape[3]), strides)
    if _plan(x.shape, w.shape, strides, pads) is None:
        return None
    cfg = (strides[0], pads[0][0], pads[0][1], pads[1][0], pads[1][1])
    return _ConvCore.apply(x, w, cfg, False)


def _amp_cast(op_name, *tensors):
    """The composed pair autocasts conv2d's x / w to the low dtype (white
    list) while the BN parameters stay float32 (batch_norm is black
    listed); this op sits in neither list, so it makes that split
    itself: x, w and the residual cast, the BN tensors untouched."""
    st = amp.policy()
    if st is None:
        return tensors
    low, _white, black, _level = st
    if op_name in black:
        return tensors
    return tuple(t.to(low) if t is not None and t.is_floating_point()
                 and t.dtype != low else t for t in tensors)


def fused_conv2d_bn_act(x, weight, scale, bias, mean, variance,
                        residual=None, *, stride=1, padding=0, dilation=1,
                        groups=1, momentum=0.9, epsilon=1e-5, act="relu",
                        is_test=False, data_format="NCHW",
                        use_global_stats=False):
    """y = act(batch_norm(conv2d(x, weight)) [+ residual]) and the
    updated running stats.

    Eval / global stats: the BN folds to one per-channel affine applied
    in the kernel's epilogue. Training: the kernel emits (z, sum,
    sum_sq) in one pass, then `_BnActCore` normalises and owns the whole
    training dx. Unsupported layouts, and every conv with
    ``FLAGS_use_pallas_conv`` off, compose conv2d + fused_bn_act."""
    from . import nn_ops

    strides = _pair(stride)
    dilations = _pair(dilation)
    x, weight, residual = _amp_cast("fused_conv2d_bn_act", x, weight,
                                    residual)
    if _use_pallas_conv() and _supported(x, weight.to(x.dtype), strides,
                                         dilations, groups, data_format):
        weight = weight.to(x.dtype)
        kh, kw = weight.shape[2], weight.shape[3]
        pad = _conv_padding(padding, 2, strides, dilations, (kh, kw))
        pads = _explicit_pads(pad, x.shape, (kh, kw), strides)
        cfg = (strides[0], pads[0][0], pads[0][1], pads[1][0], pads[1][1])
        if is_test or use_global_stats:
            inv = torch.rsqrt(variance.float() + epsilon)
            g = scale.float() * inv
            bb = bias.float() - mean.float() * g
            y = _ConvAffine.apply(x, weight, g, bb, residual, cfg, act)
            return y, (mean, variance)
        z, msum, msq = _ConvCore.apply(x, weight, cfg, True)
        cnt = z.shape[0] * z.shape[2] * z.shape[3]
        use_mean = msum / cnt
        use_var = torch.clamp_min(msq / cnt - use_mean * use_mean, 0.0)
        inv = torch.rsqrt(use_var + epsilon)
        y = _BnActCore.apply(z, scale, bias, use_mean, inv, residual, act, 1)
        new_mean = momentum * mean + (1 - momentum) * use_mean
        new_var = momentum * variance + (1 - momentum) * use_var
        return y, (new_mean.detach(), new_var.detach())
    z = nn_ops.conv2d(x, weight, stride=stride, padding=padding,
                      dilation=dilation, groups=groups,
                      data_format=data_format)
    return nn_ops.fused_bn_act(z, scale, bias, mean, variance, residual,
                               momentum=momentum, epsilon=epsilon, act=act,
                               is_test=is_test, data_format=data_format,
                               use_global_stats=use_global_stats)
