"""Flash attention (counterpart of ``flash_attention`` in
paddle_tpu/ops/fused_ops.py).

``flash_attention(q, k, v, seed, is_causal=, scale=, dropout_p=)`` on
``[batch, heads, seq, head_dim]`` is a `torch.autograd.Function`: the
forward returns ``o`` and saves ``(q, k, v, o, lse, seed)``, the
backward recomputes the probabilities from ``lse``. CUDA tensors run the
hand-written kernels of ``csrc/flash_attn.cu``, which replace the Pallas
TPU kernels of the reference:

    B1 `_fwd_kernel`      forward (o, lse)          _flash_fwd_kernel
    B2 `_bwd_dq_kernel`   backward dq               _flash_bwd_kernel
    B3 `_bwd_dkv_kernel`  backward dk, dv           _flash_bwd_kernel

A bf16 or float16 CUDA tensor launches the tensor-core kernels of all
three in its own dtype (``fwd_kernel_mma``, ``dq_kernel_mma``,
``dkv_kernel_mma``: ``mma.sync`` bf16 or f16 with f32 accumulators, one
template instantiated twice), or raises where its rows are not 16-byte
aligned (the wrapper aligns them first); an f32 one runs every pass on
the CUDA cores in full f32. No dtype is converted to reach another's
kernel.

CPU tensors run the plain PyTorch versions `_flash_fwd_plain` /
`_flash_bwd_plain`, ported from the reference's ``_flash_fwd_jnp`` /
``_flash_bwd_jnp``. ``flash_attention.launches`` is a dict counting the
launches of each kernel.

The causal mask aligns bottom-right (query i sees keys up to
``i + sk - sq``, the KV-cache convention; torch SDPA's ``is_causal``
aligns top-left), masked scores are filled with -1e30.

Attention dropout uses a counter-based mask shared by the kernels and
the plain versions: ``keep(seed, bh, q, k)`` is murmur3_32 of the three
32-bit words ``(bh, q, k)`` under the 32-bit ``seed``, compared with
``uint32((1 - p) * (2**32 - 1))``. It depends on the element only, so
every pass regenerates the same bits whatever its tiling. (The
reference seeds the TPU's PRNG per tile and its CPU path uses
jax.random, neither of which can be reproduced here.) The seed is a
device tensor read by the kernels, never synchronised to the host.
``bh`` is the element's GLOBAL batch-head index: ``bh_offset=(b0, h0,
heads)`` says that this call's rows are rows ``b0, b0 + 1, ...`` of the
whole batch and its heads are heads ``h0, h0 + 1, ...`` of ``heads``, so
a rank holding a data-parallel slice of the rows or a model-parallel
slice of the heads drops the same elements as one device holding all of
them (the reference's GSPMD masks do not depend on the layout either).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _launch
from .quant_ops import true_div

__all__ = ["flash_attention"]

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_HEAD_DIMS = (32, 64, 128)


# -- the dropout mask --------------------------------------------------------


def _mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor `a` in [0, 2**32) and a
    32-bit constant `c`, split into 16-bit halves so no product leaves
    int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _rotl32(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def _mm3_round(h, w):
    w = _mul32(w, 0xCC9E2D51)
    w = _rotl32(w, 15)
    w = _mul32(w, 0x1B873593)
    h = h ^ w
    h = _rotl32(h, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _mm3_final(h):
    h = h ^ 12
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash3(seed, w1, w2, w3):
    """murmur3_32 of the three words ``(w1[i], w2[j], w3[k])`` under
    `seed` (a 0-dim integer tensor), for int64 vectors of words in [0,
    2**32): int64 ``[len(w1), len(w2), len(w3)]`` in [0, 2**32)."""
    s = seed.to(torch.int64).reshape(()) & _M32
    h = _mm3_round(s, w1)[:, None, None]
    h = _mm3_round(h, w2[None, :, None])
    return _mm3_final(_mm3_round(h, w3[None, None, :]))


def _bh_words(bh, heads, bh_offset, dev):
    """The global batch-head words of a call's `bh` = b x `heads`
    rows: ``(b0 + b) * H + h0 + h`` for ``bh_offset`` (b0, h0, H), the
    rows' own index without one."""
    ar = torch.arange(bh, dtype=torch.int64, device=dev)
    if bh_offset is None:
        return ar
    b0, h0, total = bh_offset
    return (ar // heads + b0) * total + h0 + ar % heads


def _keep_hash(seed, bh, sq, sk, heads=1, bh_offset=None):
    """murmur3_32 of (global bh, q, k) under `seed` (a 0-dim integer
    tensor), as int64 ``[bh, sq, sk]`` in [0, 2**32); `heads` is the
    call's heads a row, `bh_offset` as `flash_attention` takes it."""
    dev = seed.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa
    return hash3(seed, _bh_words(bh, heads, bh_offset, dev), ar(sq),
                 ar(sk))


def _thresh(dropout_p):
    """uint32 keep threshold, as the reference computes it
    (``fused_ops.py:179``)."""
    return int((1.0 - dropout_p) * float(2 ** 32 - 1))


def _keep_mask(seed, bh, sq, sk, dropout_p, heads=1, bh_offset=None):
    """bool keep mask ``[bh, sq, sk]`` of the dropout shared with the
    kernels."""
    return _keep_hash(seed, bh, sq, sk, heads, bh_offset) < \
        _thresh(dropout_p)


def _offsets(heads, bh_offset):
    """(b0, h0, global heads) the kernels take."""
    return (0, 0, heads) if bh_offset is None else tuple(bh_offset)


def _keep_mask_kernel(seed, bh, sq, sk, dropout_p, heads=1, bh_offset=None):
    """The kernels' keep mask, written by their own hash on the card (a
    check of `_keep_mask`; no pass of the attention launches it)."""
    out = torch.empty((bh, sq, sk), dtype=torch.uint8, device=seed.device)
    I = _launch._I
    lib, fn = _launch.bind("flash_attn", "flash_keep_mask",
                           [_launch._P, I, I, I, ctypes.c_uint, _launch._P,
                            I, I, I, I, I, _launch._P])
    seed64 = seed.to(torch.int64).reshape(())
    _launch.launch(lib, fn, "flash_keep_mask", seed.device, out.data_ptr(),
                   bh, sq, sk, _thresh(dropout_p), seed64.data_ptr(), heads,
                   *_offsets(heads, bh_offset))
    return out.bool()


def _occupancy(pass_, dtype, d):
    """What `flash_attention` launches for pass 0 (B1), 1 (B2) or 2 (B3)
    in `dtype` at head dim `d` on the current card (`_launch.occupancy`;
    a report, no pass of the attention calls it)."""
    return _launch.occupancy("flash_attn", "flash_occupancy", pass_,
                             _launch._DTYPE_CODES[dtype], d)


# -- plain versions (the reference's jnp path) -------------------------------


def _causal_fill(s):
    sq, sk = s.shape[-2], s.shape[-1]
    q_idx = torch.arange(sq, device=s.device)[:, None]
    k_idx = torch.arange(sk, device=s.device)[None, :]
    return s.masked_fill(q_idx + (sk - sq) < k_idx, NEG_INF)


def _scores(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return _causal_fill(s) if causal else s


def _flash_fwd_plain(q, k, v, seed, scale, causal, dropout_p, heads=1,
                     bh_offset=None):
    """``_flash_fwd_jnp`` on ``[bh, s, d]`` (`heads` a batch row):
    f32 scores and softmax, probabilities rounded to the input dtype
    before the value product (f32 accumulation); returns ``(o, lse)``."""
    s = _scores(q, k, scale, causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    inv = true_div(1.0, l)
    if dropout_p > 0.0:
        inv = true_div(inv, 1.0 - dropout_p)
    probs = (p * inv[..., None]).to(q.dtype)
    if dropout_p > 0.0:
        keep = _keep_mask(seed, *s.shape, dropout_p, heads, bh_offset)
        probs = torch.where(keep, probs, torch.zeros((), dtype=probs.dtype,
                                                     device=probs.device))
    o = torch.matmul(probs.float(), v.float())
    return o.to(q.dtype), m + torch.log(l)


def _flash_bwd_plain(q, k, v, o, lse, do, seed, scale, causal, dropout_p,
                     heads=1, bh_offset=None):
    """``_flash_bwd_jnp`` on ``[bh, s, d]``; returns ``(dq, dk, dv)``."""
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    delta = (do.float() * o.float()).sum(-1)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    if dropout_p > 0.0:
        keep = _keep_mask(seed, *s.shape, dropout_p, heads, bh_offset)
        inv_keep = 1.0 / (1.0 - dropout_p)
        pd = torch.where(keep, (p * inv_keep).to(q.dtype), zero)
    else:
        keep = None
        pd = p.to(q.dtype)
    dv = torch.matmul(pd.float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp * inv_keep, 0.0)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -----------------------------------------------------------------


def _rows_contiguous(t):
    """`t` with a contiguous last dim; in bf16 and f16 also with 16-byte
    aligned rows (base and (batch, head, row) strides), which the tensor-core
    kernels copy in 16-byte chunks. The packed projection's q / k / v
    views and a transposed ``[b, s, h, d]`` gradient already are."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.dtype != torch.float32 and (
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
        t = _launch.aligned(t)
    return t


def _strides(*ts):
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1), t.stride(2)] if t is not None \
            else [0, 0, 0]
    return (ctypes.c_longlong * 18)(*vals)


def _check(q, k, v):
    if q.dtype not in _launch._DTYPE_CODES:
        raise TypeError(
            f"flash_attention: q, k, v must be float32, bfloat16 or "
            f"float16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not [b, h, s, d] with equal b, h, d")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {q.shape[3]} not supported on "
            f"CUDA (one of {_HEAD_DIMS})")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("flash_attention: batch * heads exceeds 65535")
    _launch.same_device("flash_attention", q, k, v)


def _bind():
    P, I, F = _launch._P, _launch._I, ctypes.c_float
    return _launch.bind(
        "flash_attn", "flash_attn",
        [I, I, I, P, P, P, P, P, P, P, P, P,
         ctypes.POINTER(ctypes.c_longlong), I, I, I, I, F, I, I, F,
         ctypes.c_uint, P, I, I, I, I, P])


def _launch_pass(pass_, q, k, v, do, out, out2, lse, lse_in, delta, seed,
                 scale, causal, dropout_p, bh_offset=None):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lib, fn = _bind()
    drop = dropout_p > 0.0
    _launch.launch(
        lib, fn, ("flash_attn_fwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkv")[pass_], q.device,
        pass_, _launch.dtype_code(q), d, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr() if do is not None else None,
        out.data_ptr(), out2.data_ptr() if out2 is not None else None,
        lse.data_ptr() if lse is not None else None,
        lse_in.data_ptr() if lse_in is not None else None,
        delta.data_ptr() if delta is not None else None,
        _strides(q, k, v, do, out, out2), b, h, sq, sk, float(scale),
        int(causal), int(drop),
        float(1.0 / (1.0 - dropout_p)) if drop else 1.0,
        _thresh(dropout_p) if drop else 0,
        seed.data_ptr() if drop else None, *_offsets(h, bh_offset))
    _launch.count(flash_attention.launches, ("B1", "B2", "B3")[pass_])


def _flash_fwd_kernel(q, k, v, seed, scale, causal, dropout_p,
                      bh_offset=None):
    """B1 on ``[b, h, s, d]`` (any strides with a contiguous last dim).
    ``o`` is written in ``[b, s, h, d]`` memory and returned as its
    ``[b, h, s, d]`` view, so the caller's ``transpose(1, 2)`` back to
    sequence-major is free."""
    _check(q, k, v)
    q, k, v = (_rows_contiguous(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch_pass(0, q, k, v, None, o, None, lse, None, None, seed, scale,
                 causal, dropout_p, bh_offset)
    return o, lse


def _flash_bwd_kernel(q, k, v, o, lse, do, seed, scale, causal, dropout_p,
                      bh_offset=None):
    """B2 then B3; delta = rowsum(do * o) in f32 is a torch op, as the
    reference computes it outside its kernels."""
    q, k, v, do = (_rows_contiguous(t) for t in (q, k, v, do))
    _launch.same_device("flash_attention backward", q, do, o, lse)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    lse = lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_pass(1, q, k, v, do, dq, None, None, lse, delta, seed, scale,
                 causal, dropout_p, bh_offset)
    _launch_pass(2, q, k, v, do, dk, dv, None, lse, delta, seed, scale,
                 causal, dropout_p, bh_offset)
    return dq, dk, dv


def _to3(t):
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _fwd(q, k, v, seed, scale, causal, dropout_p, bh_offset=None):
    if _launch.route(q) == "kernel":
        return _flash_fwd_kernel(q, k, v, seed, scale, causal, dropout_p,
                                 bh_offset)
    b, h = q.shape[:2]
    o, lse = _flash_fwd_plain(_to3(q), _to3(k), _to3(v), seed, scale,
                              causal, dropout_p, h, bh_offset)
    return o.reshape(b, h, *o.shape[1:]), lse.reshape(b, h, -1)


def _bwd(q, k, v, o, lse, do, seed, scale, causal, dropout_p,
         bh_offset=None):
    if _launch.route(q) == "kernel":
        return _flash_bwd_kernel(q, k, v, o, lse, do, seed, scale, causal,
                                 dropout_p, bh_offset)
    grads = _flash_bwd_plain(_to3(q), _to3(k), _to3(v), _to3(o), _to3(lse),
                             _to3(do), seed, scale, causal, dropout_p,
                             q.shape[1], bh_offset)
    return tuple(g.reshape(t.shape) for g, t in zip(grads, (q, k, v)))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, causal, scale, dropout_p, bh_offset):
        o, lse = _fwd(q, k, v, seed, scale, causal, dropout_p, bh_offset)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.cfg = (scale, causal, dropout_p, bh_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed = ctx.saved_tensors
        scale, causal, dropout_p, bh_offset = ctx.cfg
        dq, dk, dv = _bwd(q, k, v, o, lse, do, seed, scale, causal,
                          dropout_p, bh_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, seed=None, *, is_causal=False, scale=None,
                    dropout_p=0.0, bh_offset=None):
    """Flash attention over ``[batch, heads, seq, head_dim]``.

    `seed`: an integer tensor (its low 32 bits drive the dropout mask;
    ignored when ``dropout_p == 0``) on q's device, or None for 0.
    `bh_offset`: ``(b0, h0, heads)``, where this call's rows and heads
    sit in the whole batch (the dropout hash's global batch-head index;
    None: the call is the whole batch).
    CUDA tensors launch kernels B1 (forward) and B2, B3 (backward) or
    raise; CPU tensors run the plain versions."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if dropout_p > 0.0 and (q.shape[2] >= 65536 or k.shape[2] >= 65536):
        # kept from the reference, whose TPU mask packs (q, k) offsets
        # into one 32-bit word
        raise ValueError(
            "flash_attention dropout supports seq < 65536; disable "
            "dropout_p or use ring attention for longer sequences")
    if seed is None:
        seed = torch.zeros((), dtype=torch.int64, device=q.device)
    else:
        seed = torch.as_tensor(seed, device=q.device).to(
            torch.int64).reshape(())
    if bh_offset is not None:
        bh_offset = tuple(int(v) for v in bh_offset)
    return _FlashAttention.apply(q, k, v, seed, bool(is_causal), float(s),
                                 float(dropout_p), bh_offset)


flash_attention.launches = {"B1": 0, "B2": 0, "B3": 0}
