"""Port parity: paddle_tpu_torch.ops.lowp (`quant_int8`, `w8a8_matmul`)
against paddle_tpu's, BITWISE on both of the reference's paths — the lax
fallback and the Pallas kernel `_w8a8_kernel` in interpret mode
(PADDLE_TPU_LOWP_FORCE=pallas). int32 accumulation is exact, the
quantization and the epilogue are IEEE-exact elementwise formulas, so
nothing may differ. Inputs include values that land exactly on .5 after
scaling (round half to even) and values past ±127 (saturation).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import lowp as jl

from paddle_tpu_torch.ops import lowp as tl

SHAPES = [(1, 64, 97), (3, 100, 333), (8, 64, 333)]
SA = np.float32(127.0)     # x * (127 / SA) == x exactly


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 40.0).astype(np.float32)
    flat = x.reshape(-1)
    # exact halves (half-to-even decides) and saturating values
    flat[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    flat[8:12] = [127.5, 300.0, -128.0, -1000.0]
    q = rng.randint(-127, 128, (n, k)).astype(np.int8)   # [N, K] table
    sb = np.float32(0.0731)
    return x, q, sb


def test_quant_int8_bitwise_half_even_and_saturation():
    x, _, _ = _inputs(3, 100, 1)
    want = np.asarray(jl._quant_int8(jnp.asarray(x), jnp.asarray(SA)))
    got = tl.quant_int8(torch.from_numpy(x), torch.tensor(SA)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got.reshape(-1)[:12]) == [0, 2, 2, 0, -2, -2, 126, -126,
                                          127, 127, -127, -127]


@pytest.mark.parametrize("path", ["lax", "pallas"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_w8a8_matmul_bitwise(monkeypatch, path, m, k, n):
    x, q, sb = _inputs(m, k, n)
    monkeypatch.setenv("PADDLE_TPU_LOWP_FORCE", path)
    t0 = jl._TRACE_COUNT
    # the engine's call: the [N, K] table passed as its transpose
    want = np.asarray(jl.w8a8_matmul(jnp.asarray(x), jnp.asarray(q).T,
                                     jnp.asarray(sb), jnp.asarray(SA)))
    if path == "pallas":
        assert jl._TRACE_COUNT > t0      # the Pallas kernel really ran
    launches = tl.w8a8_matmul.launches
    got = tl.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(q).t(),
                         torch.tensor(sb), torch.tensor(SA)).numpy()
    assert tl.w8a8_matmul.launches == launches     # CPU: plain version
    np.testing.assert_array_equal(got, want)


def test_w8a8_matmul_bitwise_with_a_random_act_scale():
    x, q, sb = _inputs(8, 100, 97, seed=3)
    sa = np.float32(np.abs(x).max() * 0.61)   # clips the largest rows
    want = np.asarray(jl.w8a8_matmul(jnp.asarray(x), jnp.asarray(q).T,
                                     jnp.asarray(sb), jnp.asarray(sa)))
    got = tl.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(q).t(),
                         torch.tensor(sb), torch.tensor(sa)).numpy()
    np.testing.assert_array_equal(got, want)


def test_w8a8_matmul_rejects_per_row_scales():
    x, q, _ = _inputs(2, 64, 97)
    with pytest.raises(ValueError, match="per-tensor"):
        tl.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(q).t(),
                       torch.ones(97), torch.tensor(1.0))



def test_quant_int8_divides_like_the_reference():
    """127 / s is an IEEE division in the reference; values placed on
    the .5 boundaries after scaling make any other rounding of it (such
    as torch's reciprocal-multiply for ``number / tensor``) show."""
    rng = np.random.RandomState(5)
    for sa in (rng.rand(40) * 9.0 + 0.05).astype(np.float32):
        x = ((np.arange(-127, 127) + 0.5) * sa / 127.0).astype(np.float32)
        want = np.asarray(jl._quant_int8(jnp.asarray(x), jnp.asarray(sa)))
        got = tl.quant_int8(torch.from_numpy(x), torch.tensor(sa)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(sa))
