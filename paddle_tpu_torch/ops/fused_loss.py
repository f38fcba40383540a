"""Fused LM-head loss (counterpart of paddle_tpu/ops/fused_loss.py):
``cross_entropy(x @ weight.T, label)`` without the ``[N, V]`` logits.

``fused_linear_cross_entropy(x, weight, label)`` reshapes to ``[N, H]``
and calls a `torch.autograd.Function` that returns the per-row
``nll = lse - s[label]`` (f32) and saves ``(x, w, labels, lse)``; its
backward rebuilds the score tiles from ``lse``. CUDA tensors run the
hand-written kernels of ``csrc/fused_loss.cu``, which replace the
Pallas TPU kernels of the reference:

    B4 `_fwd_kernel`      forward (nll, lse)       _fwd_pallas
    B5 `_bwd_dx_kernel`   backward dx              _bwd_pallas (dx)
    B6 `_bwd_dw_kernel`   backward dw              _bwd_pallas (dw)

A bf16 or float16 CUDA tensor launches all three on warpgroup products
(``wgmma``) in its own dtype (each kernel a template instantiated for
both): B4 on ``lse_kernel`` (128 owned token rows, 64 at hidden size
1024, fed by TMA), B5 and B6 on ``wg_kernel`` (at hidden size 1024 B5
and B6 keep the ``mma.sync`` kernel, whose 32-row tile fits the
register file); f32 runs all three on the CUDA cores in full f32.

CPU tensors run the plain PyTorch versions `_fwd_plain` / `_bwd_plain`,
ported from the reference's ``_fwd_lax`` / ``_bwd_lax``: a loop over
vocab chunks of ``chunk_v`` rows of the table that never forms
``[N, V]``. The kernels tile the vocab their own way (``chunk_v`` is
the plain versions' chunk only). ``launches`` counts the launches of
each kernel.

Semantics shared by both: scores in f32 from bf16, f16 or f32 operands
(f32 accumulation), columns past the vocab masked, a row whose label
is ``ignore_index`` or -1 picks nothing (its finite nll is dropped
outside the op by a ``where``), ``lse = m + log(l)``; the backward's
``d = (softmax - onehot) * g`` is rounded to the operands' dtype before
both products, which accumulate in f32, and ``dx`` / ``dw`` come back
in that dtype.

With ``FLAGS_lowp_matmul`` on, the forward is the reference's
``_fwd_lax_lowp`` (`_fwd_lowp`), whatever the device: B4 is bypassed and
each vocab chunk's scores are a quantized product on kernel B9
(`ops.lowp`), with dynamic scales (x's abs-max, each chunk's abs-max)
and the same online statistics. The backward stays on B5 / B6 at full
precision against the low-precision lse.
"""

from __future__ import annotations

import ctypes

import torch

from ..framework import monitor
from . import _launch, lowp

__all__ = ["fused_linear_cross_entropy", "DeferredLMHead", "launches"]

_CHUNK_V = 1024
_HIDDEN = (64, 128, 256, 512, 768, 1024)

launches = {"B4": 0, "B5": 0, "B6": 0}


def _round_up(a, b):
    return -(-a // b) * b


# -- plain versions (the reference's lax path) -------------------------------


def _online_lse(x, w, labels, cv, scores):
    """The online max / sum-exp / picked logit over vocab chunks of
    ``cv`` rows, ``scores(off)`` giving chunk ``off``'s f32 ``[N, c]``
    scores; returns ``(nll, lse)``."""
    n, v = x.shape[0], w.shape[0]
    lbl = labels.long()
    m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x.device)
    picked = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for off in range(0, v, cv):
        s = scores(off)
        col = torch.arange(off, off + s.shape[1], device=x.device)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
        hit = col[None, :] == lbl[:, None]
        picked = picked + torch.where(hit, s, 0.0).sum(-1)
        m = m_new
    lse = m + torch.log(l)
    return lse - picked, lse


def _fwd_plain(x, w, labels, cv):
    """``_fwd_lax``: f32 scores of the (possibly bf16) operands (torch's
    bf16 matmul would round them to bf16)."""
    xf = x.float()

    def scores(off):
        return torch.matmul(xf, w[off:off + cv].float().t())

    return _online_lse(x, w, labels, cv, scores)


def _fwd_lowp(x, w, labels, cv, qdtype):
    """``_fwd_lax_lowp``: each chunk's scores the quantized product of x
    (one scale, its abs-max) and the chunk (its own abs-max), through
    `lowp._smm` (B9 on CUDA tensors; the chunk's transposed view read
    through its strides). The reference pads the last chunk with zero
    rows and masks their columns; here they are never formed. Counts one
    ``lowp.matmuls_<qdtype>`` call."""
    monitor.stat_add(f"lowp.matmuls_{qdtype}")
    sx = lowp.amax_of(x)

    def scores(off):
        wk = w[off:off + cv]
        return lowp._smm(x, wk.t(), sx, lowp.amax_of(wk), qdtype)

    return _online_lse(x, w, labels, cv, scores)


def _bwd_plain(x, w, labels, lse, g, cv):
    """``_bwd_lax``: per chunk, ``d = (softmax - onehot) * g`` rounded to
    x's dtype, ``dx += d @ w_chunk`` and ``dw_chunk = d^T @ x`` in f32;
    returns ``(dx, dw)`` in the operands' dtypes."""
    n, h = x.shape
    v = w.shape[0]
    xf = x.float()
    lbl = labels.long()
    dx = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    dw = torch.empty((v, h), dtype=w.dtype, device=x.device)
    for off in range(0, v, cv):
        wk = w[off:off + cv].float()
        s = torch.matmul(xf, wk.t())
        col = torch.arange(off, off + s.shape[1], device=x.device)
        hit = (col[None, :] == lbl[:, None]).float()
        d = ((torch.exp(s - lse[:, None]) - hit) * g[:, None]).to(
            x.dtype).float()
        dx += torch.matmul(d, wk)
        dw[off:off + cv] = torch.matmul(d.t(), xf).to(w.dtype)
    return dx.to(x.dtype), dw


# -- kernels -----------------------------------------------------------------


def _check(x, w, labels):
    if x.dtype not in _launch._DTYPE_CODES:
        raise TypeError(
            f"fused_linear_cross_entropy: x must be float32, bfloat16 or "
            f"float16 on CUDA, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError("fused_linear_cross_entropy: x and weight must "
                        "share one dtype")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(
            f"fused_linear_cross_entropy: x {tuple(x.shape)} and weight "
            f"{tuple(w.shape)} are not [N, H] and [V, H]")
    if x.shape[1] not in _HIDDEN:
        raise ValueError(
            f"fused_linear_cross_entropy: hidden size {x.shape[1]} not "
            f"supported on CUDA (one of {_HIDDEN})")
    if labels.shape != (x.shape[0],):
        raise ValueError("fused_linear_cross_entropy: one label per row")
    if x.shape[0] >= 2 ** 31 or w.shape[0] >= 2 ** 31 or w.shape[0] == 0:
        raise ValueError("fused_linear_cross_entropy: N and V must be in "
                         "[1, 2**31)")
    _launch.same_device("fused_linear_cross_entropy", x, w, labels)


def _bind():
    P, I = _launch._P, _launch._I
    return _launch.bind("fused_loss", "fused_lce",
                        [I, I, I, P, P, P, P, P, P, P, P, P, I, I, I, P])


def _workspace(mode, x, w):
    """The scratch the kernel of `mode` needs on x's card (B6 on
    warpgroup products: the f32 partials of the vocab tiles it splits
    over the tokens, and their counters), or None."""
    _, fn = _launch.bind("fused_loss", "fused_lce_workspace",
                         [_launch._I] * 6, ctypes.c_longlong)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nbytes = fn(mode, _launch.dtype_code(x), x.shape[1],
                x.shape[0], w.shape[0], sms)
    if nbytes < 0:
        raise ValueError("fused_lce_workspace: arguments not taken")
    return torch.empty((nbytes,), dtype=torch.uint8, device=x.device) \
        if nbytes else None


def _occupancy(mode, dtype, h):
    """What the op launches for mode 0 (B4), 1 (B5) or 2 (B6) in `dtype`
    at hidden size `h` on the current card (`_launch.occupancy`; a
    report, the op never calls it)."""
    return _launch.occupancy("fused_loss", "fused_lce_occupancy", mode,
                             _launch._DTYPE_CODES[dtype], h)


def _run(mode, x, w, labels32, lse=None, g=None, nll=None, lse_out=None,
         out=None):
    ws = _workspace(mode, x, w)
    lib, fn = _bind()
    _launch.launch(
        lib, fn, ("fused_lce_fwd", "fused_lce_dx", "fused_lce_dw")[mode],
        x.device, mode, _launch.dtype_code(x), x.shape[1],
        x.data_ptr(), w.data_ptr(), labels32.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        g.data_ptr() if g is not None else None,
        nll.data_ptr() if nll is not None else None,
        lse_out.data_ptr() if lse_out is not None else None,
        out.data_ptr() if out is not None else None,
        ws.data_ptr() if ws is not None else None, x.shape[0], w.shape[0])
    _launch.count(launches, ("B4", "B5", "B6")[mode])


def _labels32(labels):
    return labels.to(torch.int32).contiguous()


def _fwd_kernel(x, w, labels):
    """B4: ``(nll, lse)`` f32 ``[N]``."""
    _check(x, w, labels)
    x, w = _launch.aligned(x), _launch.aligned(w)
    n = x.shape[0]
    nll = torch.empty((n,), dtype=torch.float32, device=x.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n:
        _run(0, x, w, _labels32(labels), nll=nll, lse_out=lse)
    return nll, lse


def _bwd_dx_kernel(x, w, labels32, lse, g):
    """B5: dx ``[N, H]`` in x's dtype."""
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run(1, x, w, labels32, lse=lse, g=g, out=dx)
    return dx


def _bwd_dw_kernel(x, w, labels32, lse, g):
    """B6: dw ``[V, H]`` in w's dtype."""
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    _run(2, x, w, labels32, lse=lse, g=g, out=dw)
    return dw


def _bwd_kernel(x, w, labels, lse, g):
    _check(x, w, labels)
    _launch.same_device("fused_linear_cross_entropy backward", x, lse, g)
    x, w = _launch.aligned(x), _launch.aligned(w)
    if x.shape[0] == 0:
        return torch.empty_like(x), torch.zeros_like(w)
    lbl = _labels32(labels)
    lse, g = lse.float().contiguous(), g.float().contiguous()
    return (_bwd_dx_kernel(x, w, lbl, lse, g),
            _bwd_dw_kernel(x, w, lbl, lse, g))


def _fwd(x, w, labels, cv):
    qdtype = lowp.mode()
    if qdtype != "off":
        return _fwd_lowp(x, w, labels, cv, qdtype)
    if _launch.route(x) == "kernel":
        return _fwd_kernel(x, w, labels)
    return _fwd_plain(x, w, labels, cv)


def _bwd(x, w, labels, lse, g, cv):
    if _launch.route(x) == "kernel":
        return _bwd_kernel(x, w, labels, lse, g)
    return _bwd_plain(x, w, labels, lse, g, cv)


class _LinearCrossEntropy(torch.autograd.Function):
    """The reference's ``_lce`` custom_vjp: per-row raw nll (f32)."""

    @staticmethod
    def forward(ctx, x, w, labels, cv):
        nll, lse = _fwd(x, w, labels, cv)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.cv = cv
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = _bwd(x, w, labels, lse, g.float(), ctx.cv)
        return dx, dw, None, None


def fused_linear_cross_entropy(x, weight, label, *, ignore_index=-100,
                               reduction="mean", chunk_v=0):
    """cross_entropy(x @ weight.T, label) without the ``[N, V]`` logits.

    x: ``(..., H)`` hidden states, weight: ``(V, H)`` tied decoder table
    (cast to x's dtype: the cast's backward brings dw back to the
    parameter's dtype), label: ``(...)`` integer. The loss is f32;
    "mean" divides by the number of non-ignored rows, at least 1."""
    lead = x.shape[:-1]
    h = x.shape[-1]
    v = weight.shape[0]
    x2 = x.reshape(-1, h)
    lbl = label.reshape(-1)
    w = weight if weight.dtype == x2.dtype else weight.to(x2.dtype)
    cv = int(chunk_v) if chunk_v else min(_CHUNK_V, _round_up(v, 128))
    nll = _LinearCrossEntropy.apply(x2, w, lbl, cv)
    valid = lbl != ignore_index
    loss = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype,
                                               device=nll.device))
    if reduction == "none":
        return loss.reshape(lead)
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.float().sum().clamp_min(1.0)


class DeferredLMHead:
    """(hidden, tied weight) standing in for ``hidden @ weight.T``.

    `ErniePretrainingHeads` returns it in place of ``[B, S, V]`` logits
    while the fused path is on; `ErniePretrainingCriterion` consumes it
    through ``F.fused_linear_cross_entropy``. Callers that need real
    logits call `materialize`, the unfused tied matmul."""

    def __init__(self, hidden, weight):
        self.hidden = hidden
        self.weight = weight

    def materialize(self):
        from ..nn import functional as F

        return F.matmul(self.hidden, self.weight, transpose_y=True)

