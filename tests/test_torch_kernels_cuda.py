"""The port's CUDA kernels against their plain PyTorch versions, on the
card: B7 `dequant_matmul` within rtol=atol=1e-5 (f32 sums in another
order), B8 `w8a8_matmul` bitwise (exact int32 sums), each launch
counted. Without a card every test skips.

This file imports neither jax nor paddle_tpu, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import lowp, quant_ops

# the serving head's shape, then ragged ones (non-vector paths, M > 8,
# K beyond one staged tile)
SHAPES = [(8, 768, 50304), (1, 64, 97), (3, 100, 333), (13, 2100, 777)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _inputs(m, k, n):
    """Activations x [m, k] and a frozen int8 table like the engine's
    (N(0, 0.02), per tensor) on the card, with the table's scale."""
    rng = np.random.RandomState(m + k + n)
    w = (rng.randn(n, k) * 0.02).astype(np.float32)
    scale = np.float32(np.abs(w).max())
    q = np.clip(np.round(w / scale * 127), -127, 127).astype(np.int8)
    x = rng.randn(m, k).astype(np.float32)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda(),
            torch.tensor(scale).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dequant_matmul_kernel_matches_plain(m, k, n, per_row):
    _card()
    x, q, s = _inputs(m, k, n)
    if per_row:
        s = q.float().abs().amax(1) / 127.0 * s
    launches = quant_ops.dequant_matmul.launches
    got = quant_ops.dequant_matmul(x, q, s)
    assert quant_ops.dequant_matmul.launches == launches + 1
    want = quant_ops._dequant_matmul_plain(x, q, s.reshape(-1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_w8a8_kernel_bitwise(m, k, n):
    _card()
    x, q, sb = _inputs(m, k, n)
    for sa in (x.abs().max(), x.abs().max() * 0.9):
        for table in (q.t(), q.t().contiguous()):   # in place, K-major
            launches = lowp.w8a8_matmul.launches
            got = lowp.w8a8_matmul(x, table, sb, sa)
            assert lowp.w8a8_matmul.launches == launches + 1
            assert torch.equal(got, lowp._w8a8_plain(x, table, sb, sa))


@pytest.mark.cuda
def test_w8a8_kernel_rounds_half_to_even():
    _card()
    sa = torch.tensor(3.7)
    x = ((torch.arange(-127, 127) + 0.5) * sa / 127.0).repeat(8, 1).cuda()
    q = torch.randint(-127, 128, (333, x.shape[1]), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0)).cuda()
    sb, sa = torch.tensor(0.05).cuda(), sa.cuda()
    assert torch.equal(lowp.w8a8_matmul(x, q.t(), sb, sa),
                       lowp._w8a8_plain(x, q.t(), sb, sa))
