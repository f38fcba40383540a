"""Port parity: paddle_tpu_torch.ops.quant_ops against paddle_tpu's.

On the CPU the port's `dequant_matmul` runs its plain version; it is
held against the reference on both of the reference's paths — the lax
fallback and the Pallas kernel `_dq_kernel` in interpret mode
(PADDLE_TPU_QUANT_FORCE=pallas) — within rtol=atol=1e-5, since the two
f32 contractions sum in different orders. `dequant_int8` is one
elementwise IEEE formula and must agree bitwise. The CUDA kernel itself
is checked on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import quant_ops as jq

from paddle_tpu_torch.ops import quant_ops as tq

SHAPES = [(1, 64, 97), (3, 100, 333), (8, 64, 333), (8, 100, 97)]


def _inputs(m, k, n, per_row, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(n, k) * 0.02).astype(np.float32)
    if per_row:
        scale = np.abs(w).max(axis=1).astype(np.float32)
        q = np.clip(np.round(w / scale[:, None] * 127), -127, 127)
    else:
        scale = np.float32(np.abs(w).max())
        q = np.clip(np.round(w / scale * 127), -127, 127)
    return x, q.astype(np.int8), np.asarray(scale, np.float32)


@pytest.mark.parametrize("path", ["lax", "pallas"])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dequant_matmul_matches_reference(monkeypatch, path, per_row, m,
                                          k, n):
    x, q, scale = _inputs(m, k, n, per_row)
    monkeypatch.setenv("PADDLE_TPU_QUANT_FORCE", path)
    t0 = jq._TRACE_COUNT
    want = np.asarray(jq.dequant_matmul(jnp.asarray(x), jnp.asarray(q),
                                        jnp.asarray(scale)))
    if path == "pallas":
        assert jq._TRACE_COUNT > t0      # the Pallas kernel really ran
    launches = tq.dequant_matmul.launches
    got = tq.dequant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(scale)).numpy()
    assert tq.dequant_matmul.launches == launches   # CPU: plain version
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dequant_matmul_leading_dims():
    x, q, scale = _inputs(6, 64, 97, False)
    x3 = x.reshape(2, 3, 64)
    want = np.asarray(jq.dequant_matmul(jnp.asarray(x3), jnp.asarray(q),
                                        jnp.asarray(scale)))
    got = tq.dequant_matmul(torch.from_numpy(x3), torch.from_numpy(q),
                            torch.from_numpy(scale)).numpy()
    assert got.shape == (2, 3, 97)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_dequant_int8_bitwise(per_row):
    _, q, scale = _inputs(1, 100, 333, per_row)
    s = scale[:, None] if per_row else scale
    want = np.asarray(jq.dequant_int8(jnp.asarray(q), jnp.asarray(s)))
    got = tq.dequant_int8(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dequant_matmul_rejects_bad_scale_and_device():
    x, q, _ = _inputs(2, 64, 97, False)
    with pytest.raises(ValueError, match="scale"):
        tq.dequant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                          torch.ones(5))
    with pytest.raises(ValueError, match="no kernel"):
        tq.dequant_matmul(torch.empty((2, 64), device="meta"),
                          torch.empty((97, 64), dtype=torch.int8,
                                      device="meta"),
                          torch.ones((), device="meta"))

