"""w8a8 decode epilogue (counterpart of ``quant_int8`` / ``w8a8_matmul``
in paddle_tpu/ops/lowp.py).

`w8a8_matmul` quantizes activation rows per tensor to int8 against a
frozen activation scale and contracts them in int32 with a frozen int8
table. CUDA tensors run the hand-written kernel in ``csrc/lowp.cu``
(it replaces the Pallas TPU kernel ``paddle_tpu/ops/lowp.py::
_w8a8_kernel``); CPU tensors run the plain PyTorch version — the
reference's lax path. int32 sums are exact, so the two agree bitwise.
``w8a8_matmul.launches`` counts kernel launches. The scaled-matmul
training kernel (``_qmm_kernel``) is not ported yet.
"""

from __future__ import annotations

import torch

from . import _launch
from .quant_ops import true_div

__all__ = ["quant_int8", "w8a8_matmul"]

_EPS = 1e-9


def quant_int8(x, s):
    """Per-tensor int8 quantization: clip(round(x * (127 / s)), ±127);
    round is half to even, like jnp.round."""
    q = torch.round(x.to(torch.float32) * true_div(127.0, s))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


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
    w8a8_matmul.launches += 1
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
