"""Low-precision matmuls (counterpart of paddle_tpu/ops/lowp.py).

    scaled_matmul(a, b, a_scale, b_scale)   an autograd Function: the
        low-precision forward (int8 with int32 accumulation, or e4m3
        with f32 accumulation) and a straight-through bf16 backward
        against the saved full-precision operands.
    w8a8_matmul(x, qweight, scale, act_scale)   the serving epilogue:
        activations quantized against a frozen per-tensor scale and
        contracted with an int8-frozen table.

A scale is the representable abs-max of its tensor:
``q = clip(round(x * (127 / s)), ±127)`` for int8 and
``q = e4m3(clip(x * (448 / s), ±448))`` for fp8, so the epilogue factor
``s_a * s_b / qmax^2`` composes with the weights-only tables.

CUDA tensors run the hand-written kernels of ``csrc/lowp.cu``, which
replace the Pallas TPU kernels of the reference:

    B8 `_w8a8_kernel`   w8a8_matmul             (_w8a8_pallas)
    B9 `_qmm_kernel`    scaled_matmul forward   (_smm_pallas)

CPU tensors run the plain PyTorch versions `_w8a8_plain` / `_smm_plain`
(the reference's lax paths). int32 sums are exact, so int8 agrees
bitwise; fp8 sums the exact products of its e4m3 codes in f32 in other
orders (B9 multiplies them decoded to bf16, whose f32 accumulation
holds the plain version's tolerance where the tensor cores' e4m3
accumulation does not). ``w8a8_matmul.launches`` and
``scaled_matmul.launches`` count kernel launches.

Scales come from three places, in priority order: explicit arguments,
the active delayed-scaling region (a `quantization.scaling.ScaleState`
that `engine.Engine` binds around its forward with `scale_region`;
slots bind to matmul operands in call order, which in eager PyTorch is
the reference's trace order), or the current-step abs-max.

Routing (`maybe_linear`, asked first by ``F.linear``): with
``FLAGS_lowp_matmul`` off it returns None before touching anything.
Otherwise it routes inside an `Engine.train_batch` forward
(`engine_scope`, the counterpart of the reference's compiled step) and
in eager code where no operand carries autograd history (no grad mode,
or no operand requiring grad); elsewhere it returns None, as the
reference declines operands that carry a tape.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import numpy as np
import torch

from ..framework import monitor
from . import _launch
from .quant_ops import true_div

__all__ = ["mode", "QMAX", "amax_of", "quant_int8", "scaled_matmul",
           "w8a8_matmul", "maybe_linear", "scale_region", "current",
           "suppress_region", "operand_scales", "engine_scope",
           "shard_groups"]

#: representable-abs-max -> code-point factor per quantized dtype
QMAX = {"int8": 127.0, "fp8": 448.0}

_EPS = 1e-9
_TILE_MN, _TILE_K = 128, 128       # B9's tile multiples (csrc/lowp.cu)

_warned_slots = False


def mode():
    """'off' | 'int8' | 'fp8' from FLAGS_lowp_matmul."""
    from ..framework.flags import flag

    m = str(flag("FLAGS_lowp_matmul")).strip().lower()
    if m in ("", "0", "false", "no", "none", "off"):
        return "off"
    if m not in QMAX:
        raise ValueError(
            f"FLAGS_lowp_matmul must be off|int8|fp8, got {m!r}")
    return m


def _round_up(a, b):
    return -(-a // b) * b


# -- quantization (per tensor; scale = representable abs-max) -----------------


def amax_of(x):
    """The abs-max statistic of the QAT observers, clamped away from
    zero and detached: the scale input (a f32 device scalar)."""
    return x.detach().abs().amax().float().clamp_min(_EPS)


def quant_int8(x, s):
    """Per-tensor int8 quantization: clip(round(x * (127 / s)), ±127);
    round is half to even, like jnp.round, and NaN gives 0 (XLA's
    float -> int8 convert)."""
    q = torch.clamp(torch.round(x.to(torch.float32) * true_div(127.0, s)),
                    -127.0, 127.0)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8)


def _quant_f8(x, s):
    """e4m3 codes: scale to the fp8 range, saturate (the e4m3fn cast maps
    overflow to NaN, so clip first) and round to nearest even."""
    y = torch.clamp(x.to(torch.float32) * true_div(448.0, s), -448.0, 448.0)
    return y.to(torch.float8_e4m3fn)


# -- B8: w8a8 serving epilogue ------------------------------------------------


def _w8a8_plain(a, qb, sb, sa):
    """The reference's lax path. The int8 x int8 products are summed in
    float64, where every partial sum is an exact integer (|sum| < 2**53),
    so this equals int32 accumulation on any device (CUDA has no integer
    matmul)."""
    acc = torch.matmul(quant_int8(a, sa).to(torch.float64),
                       qb.to(torch.float64))
    return acc.to(torch.float32) * true_div(sa * sb, 127.0 * 127.0)


def _w8a8_kernel(a, qb, sb, sa):
    if a.dtype != torch.float32:
        raise TypeError(f"w8a8_matmul: x must be float32, got {a.dtype}")
    if qb.dtype != torch.int8 or qb.dim() != 2:
        raise ValueError(
            f"w8a8_matmul: qweight must be a 2-D int8 [K, N] table, got "
            f"{qb.dtype} {tuple(qb.shape)}")
    _launch.same_device("w8a8_matmul", a, qb, sa, sb)
    a = a.contiguous()
    m, k = a.shape
    n = qb.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    P, I, L = _launch._P, _launch._I, _launch._L
    lib, fn = _launch.bind("lowp", "w8a8_matmul_f32_i8",
                           [P, P, P, P, P, I, I, I, L, L, L, I, P])
    _launch.launch(lib, fn, "w8a8_matmul", a.device,
                   a.data_ptr(), qb.data_ptr(), sa.data_ptr(),
                   sb.data_ptr(), out.data_ptr(), m, n, k, a.stride(0),
                   qb.stride(0), qb.stride(1))
    _launch.count(w8a8_matmul)
    return out


def w8a8_matmul(x, qweight, scale, act_scale):
    """w8a8 decode epilogue: quantize activation rows to int8 against
    the frozen per-tensor `act_scale` and contract with the int8-frozen
    table `qweight`, a logical ``[K, N]`` view — the engine passes the
    transpose of its ``[N, K]`` table, which the kernel reads in place
    through its strides. `scale` and `act_scale` are per-tensor scalars
    (each clamped to >= 1e-9) and may be device tensors: they are read
    by the kernel, never synchronised to the host. Returns (..., N)
    float32."""
    lead, k = x.shape[:-1], x.shape[-1]
    if qweight.shape[0] != k:
        raise ValueError(
            f"w8a8_matmul: x (..., {k}) vs qweight {tuple(qweight.shape)}")
    x2 = x.reshape(-1, k)
    sb = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32,
                                         device=x.device), _EPS)
    sa = torch.clamp_min(torch.as_tensor(act_scale, dtype=torch.float32,
                                         device=x.device), _EPS)
    if sb.numel() != 1 or sa.numel() != 1:
        raise ValueError("w8a8_matmul: scales are per-tensor scalars")
    sb, sa = sb.reshape(()), sa.reshape(())
    if _launch.route(x) == "plain":
        out = _w8a8_plain(x2, qweight, sb, sa)
    else:
        out = _w8a8_kernel(x2, qweight, sb, sa)
    return out.reshape(*lead, qweight.shape[1])


w8a8_matmul.launches = 0


def _w8a8_occupancy(m, k):
    """What B8 launches for `m` rows of x at depth `k` on the current card
    (`_launch.occupancy`; a report, the op never calls it)."""
    return _launch.occupancy("lowp", "w8a8_matmul_occupancy", m, k)


# -- B9: scaled matmul --------------------------------------------------------


def _smm_plain(a, b, sa, sb, qdtype):
    """The reference's ``_smm_lax``: int8 codes summed in float64 (every
    partial sum an exact integer, so it equals int32 accumulation), or
    the decoded e4m3 values multiplied in f32 (TF32 off); then the f32
    epilogue ``acc * (sa * sb / qmax^2)``."""
    if qdtype == "int8":
        acc = torch.matmul(quant_int8(a, sa).to(torch.float64),
                           quant_int8(b, sb).to(torch.float64))
        return acc.to(torch.float32) * true_div(sa * sb, 127.0 * 127.0)
    acc = torch.matmul(_quant_f8(a, sa).to(torch.float32),
                       _quant_f8(b, sb).to(torch.float32))
    return acc * true_div(sa * sb, 448.0 * 448.0)


def _smm_kernel(a, b, sa, sb, qdtype):
    """B9 on a [M, K] (unit column stride) and b [K, N] (any strides),
    f32, bf16 or f16 each (the quantise passes read each in its own
    dtype: under float16 amp the reference hands them f16 activations
    and, after `amp.decorate`, f16 weights); returns [M, N] f32. The
    quantized operands go to scratch buffers padded to the kernel's
    tiles."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _launch._DTYPE_CODES or t.dim() != 2:
            raise TypeError(
                f"scaled_matmul: {name} must be a 2-D float32, bfloat16 or "
                f"float16 tensor on CUDA, got {t.dtype} {tuple(t.shape)}")
    _launch.same_device("scaled_matmul", a, b, sa, sb)
    if a.stride(1) != 1:
        a = a.contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    mp, np_ = _round_up(m, _TILE_MN), _round_up(n, _TILE_MN)
    kp = _round_up(max(k, 1), _TILE_K)
    # int8 codes, or the e4m3 codes decoded to bf16 (the form fp8's GEMM
    # multiplies): 1 or 2 bytes a code
    width = 2 if qdtype == "fp8" else 1
    qa = torch.empty((mp, kp * width), dtype=torch.uint8, device=a.device)
    qb = torch.empty((np_, kp * width), dtype=torch.uint8, device=a.device)
    sa, sb = (s.to(torch.float32).contiguous() for s in (sa, sb))
    P, I, L = _launch._P, _launch._I, _launch._L
    lib, fn = _launch.bind(
        "lowp", "scaled_matmul_q",
        [P, I, L, P, I, L, L, P, P, P, P, P, I, I, I, I, I, I, I, I, P])
    _launch.launch(lib, fn, "scaled_matmul", a.device,
                   a.data_ptr(), _launch.dtype_code(a), a.stride(0),
                   b.data_ptr(), _launch.dtype_code(b), b.stride(0),
                   b.stride(1), sa.data_ptr(), sb.data_ptr(), qa.data_ptr(),
                   qb.data_ptr(), out.data_ptr(), m, n, k, mp, np_, kp,
                   int(qdtype == "fp8"))
    _launch.count(scaled_matmul)
    return out


def _occupancy(qdtype):
    """What B9's GEMM launches in `qdtype` on the current card
    (`_launch.occupancy`; a report, the op never calls it)."""
    return _launch.occupancy("lowp", "scaled_matmul_occupancy",
                             int(qdtype == "fp8"))


def _smm(a, b, sa, sb, qdtype):
    if _launch.route(a) == "plain":
        return _smm_plain(a, b, sa, sb, qdtype)
    return _smm_kernel(a, b, sa, sb, qdtype)


def _bf16_mm(x, y):
    """x @ y of two bf16 matrices, products accumulated in f32 (the
    reference's ``preferred_element_type=f32``): the library's bf16 GEMM
    with an f32 output on the card, an f32 matmul of the bf16 values
    on the CPU (bf16 products are exact in f32)."""
    if x.device.type == "cuda":
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.mm(x.to(torch.float32), y.to(torch.float32))


class _ScaledMatmul(torch.autograd.Function):
    """The reference's ``_smm`` custom_vjp: the low-precision forward
    (B9) and a straight-through backward, bf16 products of the upstream
    gradient and the SAVED full-precision operands, accumulated in f32
    and cast to each operand's dtype. The scales get no gradient."""

    @staticmethod
    def forward(ctx, a, b, sa, sb, qdtype):
        ctx.save_for_backward(a, b)
        return _smm(a, b, sa, sb, qdtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _bf16_mm(g16, b.to(torch.bfloat16).t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _bf16_mm(a.to(torch.bfloat16).t(), g16).to(b.dtype)
        return da, db, None, None, None


def _scale(s, x):
    return torch.clamp_min(torch.as_tensor(s, dtype=torch.float32,
                                           device=x.device), _EPS).reshape(())


def scaled_matmul(a, b, a_scale=None, b_scale=None, out_dtype=None,
                  qdtype=None):
    """``a @ b`` computed in low precision with int32 / f32 accumulation.

    a: (..., K) float, b: (K, N) float (any strides). Scales are
    per-tensor representable-abs-max scalars (device tensors are never
    read on the host); None takes the current abs-max. qdtype None
    follows FLAGS_lowp_matmul ('off' there still computes int8: callers
    gate routing, this op always quantizes). Returns (..., N) f32, or
    `out_dtype`. Counts one ``lowp.matmuls_<qdtype>`` call."""
    if qdtype is None:
        m = mode()
        qdtype = m if m != "off" else "int8"
    if qdtype not in QMAX:
        raise ValueError(f"qdtype must be int8|fp8, got {qdtype!r}")
    if a.dim() < 1 or b.dim() != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(
            f"scaled_matmul expects a (..., K) and b (K, N); got "
            f"{tuple(a.shape)} x {tuple(b.shape)}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    sa = amax_of(a2) if a_scale is None else _scale(a_scale, a)
    sb = amax_of(b) if b_scale is None else _scale(b_scale, b)
    monitor.stat_add(f"lowp.matmuls_{qdtype}")
    out = _ScaledMatmul.apply(a2, b, sa, sb, qdtype)
    out = out.reshape(*lead, b.shape[1])
    return out if out_dtype is None else out.to(out_dtype)


scaled_matmul.launches = 0


# -- delayed-scaling region and routing ---------------------------------------

_tls = threading.local()


class _ScaleRegion:
    """Binds ScaleState slots to matmul operands in call order. Every
    recorded value is a device tensor; `updated` folds them into the
    next state without a host read."""

    def __init__(self, state):
        self.state = state
        self.capacity = int(state.scale.shape[0])
        self.n = 0
        self._amax = []                 # this step's amax of slot i
        self._clipped = torch.zeros((), dtype=torch.float32,
                                    device=state.scale.device)
        self._total = np.float32(0.0)   # the reference's f32 running sum

    def slot(self):
        i = self.n
        self.n += 1
        if i >= self.capacity:
            global _warned_slots
            if not _warned_slots:
                _warned_slots = True
                warnings.warn(
                    f"lowp: more quantized matmul operands than the "
                    f"ScaleState capacity {self.capacity} "
                    "(FLAGS_lowp_slots); extras use dynamic scaling")
            monitor.stat_add("lowp.slot_overflow")
            return None
        return i

    def scale_for(self, i, x, amax=None):
        """Delayed scale for slot i; the very first step has an empty
        history, so it falls back to the current abs-max."""
        cur = amax_of(x) if amax is None else amax
        return torch.where(self.state.step > 0,
                           torch.clamp_min(self.state.scale[i], _EPS), cur)

    def record(self, i, x, s, amax=None):
        """This step's abs-max of slot i and its clip count against s.
        Slots are recorded in the order `slot` hands them out."""
        if i != len(self._amax):
            raise RuntimeError("lowp: slots must be recorded in order")
        self._amax.append(amax_of(x) if amax is None else amax)
        self._clipped = self._clipped + (x.detach().abs() > s).sum(
            dtype=torch.float32)
        self._total = np.float32(self._total + np.float32(x.numel()))

    def updated(self):
        """The next ScaleState: this step's amaxes ring-written and the
        delayed-scale schedule applied (on the device)."""
        from ..quantization.scaling import update_scale_state

        dev = self.state.scale.device
        seen = len(self._amax)
        amax = torch.zeros((self.capacity,), dtype=torch.float32, device=dev)
        if seen:
            amax = torch.cat([torch.stack(self._amax), amax[seen:]])
        mask = torch.arange(self.capacity, device=dev) < seen
        total = torch.full((), float(self._total), dtype=torch.float32,
                           device=dev)
        return update_scale_state(self.state, amax, mask, self._clipped,
                                  total)


@contextlib.contextmanager
def scale_region(state):
    """Bind a ScaleState to the matmuls of the enclosed forward. None
    (or lowp off) is a no-op yielding None; routing then uses dynamic
    scales."""
    if state is None or mode() == "off":
        yield None
        return
    prev = getattr(_tls, "region", None)
    _tls.region = _ScaleRegion(state)
    try:
        yield _tls.region
    finally:
        _tls.region = prev


def current():
    """The active delayed-scaling region, or None."""
    return getattr(_tls, "region", None)


@contextlib.contextmanager
def suppress_region():
    """Hide the active region from the enclosed code (recompute
    segments, the counterpart of the reference's sub-traces): their
    matmuls quantize with dynamic scales and record nothing."""
    prev = getattr(_tls, "region", None)
    _tls.region = None
    try:
        yield
    finally:
        _tls.region = prev


def in_engine_scope():
    """True inside an engine step's forward (`engine_scope`)."""
    return getattr(_tls, "engine", False)


@contextlib.contextmanager
def engine_scope(on=True):
    """Mark the enclosed code as an engine step's forward, where
    `maybe_linear` routes operands that require grad (the reference's
    compiled step). A recomputed segment's replay passes the value that
    `in_engine_scope` had at its first run."""
    prev = in_engine_scope()
    _tls.engine = on
    try:
        yield
    finally:
        _tls.engine = prev


@contextlib.contextmanager
def shard_groups(a=None, b=None):
    """Inside: the matmul operand a (b) of `operand_scales` is this
    rank's shard of a tensor split over the process group `a` (`b`), so
    its abs-max is reduced (max) over that group; None leaves an operand
    whole. Every rank of the group then takes one device's scale, and
    the delayed-scaling history records it."""
    prev = getattr(_tls, "groups", None)
    _tls.groups = (a, b)
    try:
        yield
    finally:
        _tls.groups = prev


def _agreed(aa, ab):
    """The abs-maxes (aa, ab) reduced over their `shard_groups` groups."""
    groups = getattr(_tls, "groups", None)
    if groups is None or groups == (None, None):
        return aa, ab
    from ..distributed.collective import ReduceOp, all_reduce

    ga, gb = groups
    if ga is not None and ga is gb:
        both = torch.stack([aa, ab])
        all_reduce(both, ReduceOp.MAX, group=ga)
        return both[0], both[1]
    if ga is not None:
        aa = all_reduce(aa.clone(), ReduceOp.MAX, group=ga)
    if gb is not None:
        ab = all_reduce(ab.clone(), ReduceOp.MAX, group=gb)
    return aa, ab


def operand_scales(a, b):
    """(a_scale, b_scale) for one matmul: delayed-scaling slots when a
    region is active, dynamic abs-max otherwise (each reduced over the
    group that holds the operand in shards, `shard_groups`). Also
    records this step's amaxes and clip counts into the region."""
    ctx = current()
    aa, ab = _agreed(amax_of(a), amax_of(b))
    if ctx is None:
        return aa, ab
    ia, ib = ctx.slot(), ctx.slot()
    sa = aa if ia is None else ctx.scale_for(ia, a, aa)
    sb = ab if ib is None else ctx.scale_for(ib, b, ab)
    if ia is not None:
        ctx.record(ia, a, sa, aa)
    if ib is not None:
        ctx.record(ib, b, sb, ab)
    return sa, sb


def maybe_linear(x, weight):
    """Lowp route for ``F.linear`` (bias NOT applied): the output tensor
    in ``result_type(x, weight)``, or None to keep the ``matmul_v2``
    path — flag off, operands with autograd history outside an engine
    step, or non-float / low-rank operands. 'off' returns None before
    touching anything."""
    if mode() == "off":
        return None
    if not (isinstance(x, torch.Tensor) and isinstance(weight, torch.Tensor)):
        return None
    if not in_engine_scope() and torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad):
        return None
    if x.dim() < 2 or weight.dim() != 2:
        return None
    if not (x.is_floating_point() and weight.is_floating_point()):
        return None
    m = mode()
    sa, sb = operand_scales(x, weight)
    return scaled_matmul(x, weight, sa, sb, qdtype=m,
                         out_dtype=torch.result_type(x, weight))
