"""Frozen-int8 decode primitives (counterpart of the serving half of
paddle_tpu/ops/quant_ops.py).

    dequant_int8(q, scale)      the ONE dequant formula everywhere:
                                q_f32 * (scale / 127.0).
    dequant_matmul(x, q, scale) x @ dequant(q).T with the dequant as a
                                matmul EPILOGUE — contract against the
                                raw int8 rows and scale the [*, N]
                                output. Algebraically equal to operand
                                dequant, bitwise a different formula.

`dequant_matmul` runs the hand-written CUDA kernel in
``csrc/quant_ops.cu`` (it replaces the Pallas TPU kernel
``paddle_tpu/ops/quant_ops.py::_dq_kernel``) on CUDA tensors and its
plain PyTorch version — the reference's lax path — on CPU tensors.
``dequant_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _launch

__all__ = ["dequant_int8", "dequant_matmul", "true_div"]


def true_div(a, b):
    """IEEE ``a / b`` in float32 with at least one tensor operand. torch
    divides by a Python number through its reciprocal on CUDA, and
    ``number / tensor`` through the tensor's reciprocal everywhere — both
    round differently from the reference's division — so the number is
    made a tensor first."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def dequant_int8(q, scale):
    """Canonical int8 dequant: q_f32 * (scale / 127.0), in that order
    (``(q * scale) / 127`` differs bitwise)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * true_div(s, 127.0)


def _dequant_matmul_plain(x2, q, sc):
    """The reference's lax path: f32 contraction against the int8 rows,
    then the per-column epilogue ``scale / 127``."""
    return torch.matmul(x2, q.to(torch.float32).t()) * true_div(sc, 127.0)


def _dequant_matmul_kernel(x2, q, sc):
    if x2.dtype != torch.float32:
        raise TypeError(f"dequant_matmul: x must be float32, got {x2.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2 or q.stride(1) != 1:
        raise ValueError(
            "dequant_matmul: qweight must be a 2-D int8 [N, K] table with "
            f"contiguous rows, got {q.dtype} {tuple(q.shape)} strides "
            f"{q.stride()}")
    _launch.same_device("dequant_matmul", x2, q, sc)
    x2 = x2.contiguous()
    sc = sc.contiguous()
    m, k = x2.shape
    n = q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if out.numel() == 0:
        return out
    P, I, L = _launch._P, _launch._I, _launch._L
    lib, fn = _launch.bind("quant_ops", "dequant_matmul_f32_i8",
                           [P, P, P, P, I, I, I, L, L, I, I, P])
    _launch.launch(lib, fn, "dequant_matmul", x2.device,
                   x2.data_ptr(), q.data_ptr(), sc.data_ptr(),
                   out.data_ptr(), m, n, k, x2.stride(0), q.stride(0),
                   0 if sc.numel() == 1 else 1)
    dequant_matmul.launches += 1
    return out


def dequant_matmul(x, qweight, scale):
    """out = x @ dequant_int8(qweight, scale).T without materialising the
    dequantized weight.

    x: (..., K) float32; qweight: (N, K) int8 (the LM head's tied
    embedding table); scale: scalar or (N,) per-row float32. Returns
    (..., N) float32. CUDA tensors go through the B7 kernel (no
    fallback), CPU tensors through the plain version."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = qweight.shape[0]
    if qweight.shape[-1] != k:
        raise ValueError(
            f"dequant_matmul: x (..., {k}) vs qweight {tuple(qweight.shape)}")
    x2 = x.reshape(-1, k)
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=x.device).reshape(-1)
    if sc.numel() not in (1, n):
        raise ValueError(
            f"dequant_matmul: scale must be a scalar or ({n},), got "
            f"{tuple(sc.shape)}")
    if _launch.route(x) == "plain":
        out = _dequant_matmul_plain(x2, qweight, sc)
    else:
        out = _dequant_matmul_kernel(x2, qweight, sc)
    return out.reshape(*lead, n)


dequant_matmul.launches = 0
