"""Port parity: paddle_tpu_torch.ops.lowp against paddle_tpu's.

B8 (`quant_int8`, `w8a8_matmul`), BITWISE on both of the reference's
paths — the lax fallback and the Pallas kernel `_w8a8_kernel` in
interpret mode (PADDLE_TPU_LOWP_FORCE=pallas). int32 accumulation is
exact, the quantization and the epilogue are IEEE-exact elementwise
formulas, so nothing may differ. Inputs include values that land
exactly on .5 after scaling (round half to even) and values past ±127
(saturation).

B9 (`scaled_matmul`, the training path's plain version): int8 bitwise
against ``_smm_lax`` and an int64 oracle, and against the Pallas
``_qmm_kernel`` in interpret mode up to the one formula that differs
(named in its test); ``_quant_f8`` bitwise at e4m3's ties, ±448 and its
subnormals; fp8 within 4 K 2^-24 of the sum of the absolute products;
the straight-through bf16 gradients against ``jax.vjp``; the delayed
scaling schedule (`quantization.scaling`) bitwise over injected
amaxes; the fused loss's low-precision forward against
``_fwd_lax_lowp``; routing and slot overflow.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags as jflags
from paddle_tpu.ops import fused_loss as jfl
from paddle_tpu.ops import lowp as jl
from paddle_tpu.quantization import scaling as jscaling

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.ops import fused_loss as tfl
from paddle_tpu_torch.ops import lowp as tl
from paddle_tpu_torch.quantization import scaling as tscaling

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


# -- B9: scaled_matmul (the training path) ------------------------------------

# (m, k, n): ragged against B9's 128 x 128 x 128 tiles, N = 2 as the NSP
# head, K = 100 off every tile multiple, K just past one 128-deep step
# (129) and off two (200, 3000), M and N just past a tile edge (129, 257)
SMM_SHAPES = [(24, 40, 12), (7, 100, 333), (33, 64, 2), (1, 128, 3),
              (129, 129, 257), (257, 200, 129), (9, 3000, 130)]


def _smm_inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed + m + k + n)
    a = (rng.randn(m, k) * 3.0).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    return a, b


def _int64_oracle(a, b, sa, sb):
    """The int8 codes of the reference's formula, contracted exactly."""
    def codes(x, s):
        inv = np.float32(np.float32(127.0) / np.float32(s))
        return np.clip(np.rint(x * inv), -127, 127).astype(np.int64)
    return codes(a, sa) @ codes(b, sb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SMM_SHAPES)
def test_scaled_matmul_int8_bitwise_against_lax_and_oracle(monkeypatch, m, k,
                                                           n, dtype):
    """The plain int8 version equals ``_smm_lax`` bit for bit (the same
    codes, exact sums, the same IEEE epilogue) and its accumulator equals
    an int64 oracle; bf16 operands enter as bf16 in both."""
    a, b = _smm_inputs(m, k, n)
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    monkeypatch.setenv("PADDLE_TPU_LOWP_FORCE", "lax")
    want = np.asarray(jl.scaled_matmul(ja, jb, qdtype="int8"))
    launches = tl.scaled_matmul.launches
    got = tl.scaled_matmul(ta, tb, qdtype="int8").numpy()
    assert tl.scaled_matmul.launches == launches     # CPU: plain version
    np.testing.assert_array_equal(got, want)
    sa, sb = (float(t.float().abs().max()) for t in (ta, tb))
    acc = _int64_oracle(ta.float().numpy(), tb.float().numpy(), sa, sb)
    epi = np.float32(np.float32(sa) * np.float32(sb)) / np.float32(16129.0)
    np.testing.assert_array_equal(got, acc.astype(np.float32) * epi)


@pytest.mark.parametrize("m,k,n", SMM_SHAPES)
def test_scaled_matmul_int8_against_the_pallas_kernel(monkeypatch, m, k, n):
    """Against ``_qmm_kernel`` in interpret mode: the accumulators agree
    exactly, and so does the epilogue once its one difference is
    named: the interpreted kernel multiplies by the reciprocal of
    127^2 (XLA folds the constant division), where ``_smm_lax`` and the
    port divide (IEEE), so the reference's own two paths differ by up
    to two f32 ulps."""
    a, b = _smm_inputs(m, k, n, seed=1)
    monkeypatch.setenv("PADDLE_TPU_LOWP_FORCE", "pallas")
    t0 = jl._TRACE_COUNT
    want = np.asarray(jl.scaled_matmul(a, b, qdtype="int8"))
    assert jl._TRACE_COUNT > t0          # the Pallas kernel really ran
    got = tl.scaled_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           qdtype="int8").numpy()
    sa, sb = np.abs(a).max(), np.abs(b).max()
    acc = _int64_oracle(a, b, sa, sb)
    epi = np.float32(np.float32(sa) * np.float32(sb)) / np.float32(16129.0)
    for out in (got, want):
        np.testing.assert_array_equal(
            np.rint(out.astype(np.float64) / epi).astype(np.int64), acc)
    np.testing.assert_array_equal(got, acc.astype(np.float32) * epi)
    recip = np.float32(np.float32(sa) * np.float32(sb)) * \
        np.float32(np.float32(1.0) / np.float32(16129.0))
    np.testing.assert_array_equal(want, acc.astype(np.float32) * recip)
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def _f8_probe_values():
    """Ties of e4m3 rounding, the ±448 edge and past it, subnormals
    (2^-9 .. 2^-6) and their ties, zero and random values."""
    base = [0.0, -0.0, 448.0, -448.0, 449.0, 464.0, 500.0, -1e4, 1e30,
            2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 5 * 2.0 ** -10,
            2.0 ** -6 - 2.0 ** -10, 2.0 ** -7 + 2.0 ** -10, 1e-6]
    ties = [(1.0 + (2 * j + 1) / 16.0) * 2.0 ** e for e in range(-6, 8)
            for j in range(8)]       # halfway between two e4m3 values
    rnd = np.random.RandomState(7).randn(200) * 60.0
    vals = np.concatenate([base, ties, np.negative(ties), rnd])
    return vals.astype(np.float32)


@pytest.mark.parametrize("s", [448.0, 3.5, 0.0123])
def test_quant_f8_bitwise(s):
    x = _f8_probe_values() * np.float32(s / 448.0)
    if s == 448.0:
        x = _f8_probe_values()       # the probe values land unscaled
    want = np.asarray(jl._quant_f8(jnp.asarray(x), jnp.float32(s)))
    got = tl._quant_f8(torch.from_numpy(x), torch.tensor(np.float32(s)))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  want.view(np.uint8))


@pytest.mark.parametrize("m,k,n", SMM_SHAPES)
def test_scaled_matmul_fp8_within_tolerance(monkeypatch, m, k, n):
    """fp8 sums the exact e4m3 products in f32 in another order than
    XLA: each element within 4 K 2^-24 of the sum of the absolute
    products (the bound chip_smoke.py holds B9 to)."""
    a, b = _smm_inputs(m, k, n, seed=2)
    monkeypatch.setenv("PADDLE_TPU_LOWP_FORCE", "lax")
    want = np.asarray(jl.scaled_matmul(a, b, qdtype="fp8"))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tl.scaled_matmul(ta, tb, qdtype="fp8").numpy()
    sa, sb = tl.amax_of(ta), tl.amax_of(tb)
    qa = tl._quant_f8(ta, sa).double().abs()
    qb = tl._quant_f8(tb, sb).double().abs()
    epi = float(sa) * float(sb) / 448.0 ** 2
    tol = 4 * k * 2.0 ** -24 * (qa @ qb).numpy() * epi
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol + 1e-30)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_matmul_straight_through_grads_match_jax_vjp(qdtype, dtype):
    """The backward is bf16 products of the upstream gradient and the
    saved operands, f32 sums: against ``jax.vjp`` of the reference's
    op within 1e-5 of the largest gradient (f32 sums in another order),
    each grad in its operand's dtype; no gradient reaches the scales."""
    a, b = _smm_inputs(9, 40, 13, seed=3)
    g = np.random.RandomState(4).randn(9, 13).astype(np.float32)
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    _, vjp = jax.vjp(lambda x, y: jl.scaled_matmul(x, y, qdtype=qdtype),
                     ja, jb)
    wa, wb = (np.asarray(t.astype(jnp.float32)) for t in vjp(
        jnp.asarray(g)))
    ta = torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
    tb = torch.from_numpy(b).to(getattr(torch, dtype)).requires_grad_(True)
    sa = tl.amax_of(ta).requires_grad_(True)
    out = tl.scaled_matmul(ta, tb, sa, None, qdtype=qdtype)
    out.backward(torch.from_numpy(g))
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    assert sa.grad is None
    for got, want in ((ta.grad, wa), (tb.grad, wb)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _state_pair(cap, h):
    return (jscaling.init_scale_state(capacity=cap, history=h),
            tscaling.init_scale_state(capacity=cap, history=h, device="cpu"))


def _assert_state_equal(got, want):
    for name in tscaling.ScaleState._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.fixture
def lowp_flags():
    """Restore both packages' FLAGS_lowp_* after the test."""
    names = ["FLAGS_lowp_matmul", "FLAGS_lowp_amax_history",
             "FLAGS_lowp_amax_margin", "FLAGS_lowp_scale_interval",
             "FLAGS_lowp_slots"]
    saved = (jflags.get_flags(names), tflags.get_flags(names))

    def both(values):
        jflags.set_flags(values)
        tflags.set_flags(values)
    yield both
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


@pytest.mark.parametrize("interval,margin", [(1, 0), (2, 1), (3, 2)])
def test_update_scale_state_matches_reference(lowp_flags, interval, margin):
    """Injected amaxes through both schedules, bit for bit: the ring
    wraps (H = 3, 7 steps), slots go unseen and come back, the interval
    and the margin hold the scale between updates, a never-seen slot
    keeps its unit scale, and the f32 counters accumulate."""
    lowp_flags({"FLAGS_lowp_scale_interval": interval,
                "FLAGS_lowp_amax_margin": margin})
    js, ts = _state_pair(4, 3)
    rng = np.random.RandomState(interval * 10 + margin)
    for step in range(7):
        amax = (rng.rand(4) * 8.0).astype(np.float32)
        mask = rng.rand(4) > 0.3
        mask[3] = False                       # never seen
        if step == 5:
            mask[:] = False                   # an idle step
        clipped = np.float32(rng.randint(0, 50))
        total = np.float32(1000 + step)
        js = jscaling.update_scale_state(js, jnp.asarray(amax),
                                         jnp.asarray(mask),
                                         jnp.asarray(clipped),
                                         jnp.asarray(total))
        ts = tscaling.update_scale_state(ts, torch.from_numpy(amax),
                                         torch.from_numpy(mask),
                                         torch.tensor(clipped),
                                         torch.tensor(total))
        _assert_state_equal(ts, js)
    assert float(ts.scale[3]) == 1.0
    assert int(ts.updates) == 7 // interval


def test_publish_scale_state_feeds_monitor():
    st = tscaling.init_scale_state(capacity=2, history=4, device="cpu")
    st = st._replace(updates=torch.tensor(7, dtype=torch.int32),
                     clipped=torch.tensor(5.0), total=torch.tensor(1000.0))
    assert tscaling.publish_scale_state(st) == pytest.approx(0.005)
    assert tmonitor.stat_get("lowp.scale_updates") == 7
    assert tmonitor.stat_get("lowp.clip_rate_ppm") == 5000
    assert tmonitor.stat_get("lowp.amax_history_depth") == 4
    assert tmonitor.stat_get("lowp.clipped_elems") == 5
    assert tmonitor.stat_get("lowp.quantized_elems") == 1000


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("n,h,v,cv", [(37, 64, 301, 128),
                                      (50, 128, 1000, 256)])
def test_fused_loss_lowp_forward_matches_reference(lowp_flags, qdtype, n, h,
                                                   v, cv):
    """``_fwd_lax_lowp``'s (nll, lse) against the port's lowp forward:
    vocab tails (the reference's zero-padded chunk), 30% ignored rows;
    within 1e-5 for int8 (exact scores, the online sums in another
    order) and fp8 (the same codes; f32 score sums in another order)."""
    lowp_flags({"FLAGS_lowp_matmul": qdtype})
    rng = np.random.RandomState(n + v)
    x = (rng.randn(n, h) * 0.5).astype(np.float32)
    w = (rng.randn(v, h) * 0.1).astype(np.float32)
    lbl = rng.randint(0, v, (n,)).astype(np.int32)
    lbl[rng.rand(n) < 0.3] = -100
    jnll, jlse = jfl._fwd_lax_lowp(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(lbl), cv, qdtype)
    before = tmonitor.stat_get(f"lowp.matmuls_{qdtype}")
    tnll, tlse = tfl._fwd(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(lbl).long(), cv)
    assert tmonitor.stat_get(f"lowp.matmuls_{qdtype}") == before + 1
    np.testing.assert_allclose(tnll.numpy(), np.asarray(jnll), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


def test_maybe_linear_routes_only_without_autograd_history(lowp_flags):
    """Flag off: None before touching anything. On: an operand that
    requires grad declines outside an engine step; no_grad, untracked
    operands and `engine_scope` route, in result_type(x, w)."""
    x = torch.randn(4, 8)
    w = torch.randn(8, 3, requires_grad=True)
    lowp_flags({"FLAGS_lowp_matmul": "off"})
    assert tl.maybe_linear(x, w.detach()) is None
    lowp_flags({"FLAGS_lowp_matmul": "int8"})
    assert tl.maybe_linear(x, w) is None
    with torch.no_grad():
        out = tl.maybe_linear(x, w)
    assert out is not None and out.dtype == torch.float32
    want = tl.scaled_matmul(x, w.detach(), qdtype="int8")
    assert torch.equal(out, want)
    assert tl.maybe_linear(x.bfloat16(), w.detach()).dtype == torch.float32
    assert tl.maybe_linear(x.bfloat16(), w.detach().bfloat16()).dtype == \
        torch.bfloat16
    with tl.engine_scope():
        routed = tl.maybe_linear(x, w)
    assert routed.requires_grad and torch.equal(routed.detach(), want)
    assert tl.maybe_linear(x[0], w.detach()) is None        # rank 1


def test_slot_overflow_falls_back_to_dynamic(lowp_flags):
    """Past the capacity, operands take their current abs-max and are
    not recorded; the overflow is counted."""
    state = tscaling.init_scale_state(capacity=3, history=2, device="cpu")
    state = state._replace(step=torch.tensor(1, dtype=torch.int32),
                           scale=torch.tensor([5.0, 6.0, 7.0]))
    lowp_flags({"FLAGS_lowp_matmul": "int8"})
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    before = tmonitor.stat_get("lowp.slot_overflow")
    with tl.scale_region(state) as rec:
        s0 = tl.operand_scales(a, b)
        s1 = tl.operand_scales(a, b)
    assert tmonitor.stat_get("lowp.slot_overflow") == before + 1
    assert [float(s) for s in s0] == [5.0, 6.0]
    assert float(s1[0]) == 7.0 and float(s1[1]) == float(tl.amax_of(b))
    new = rec.updated()                # step 1 writes ring column 1
    assert torch.equal(new.history[:, 1], torch.stack(
        [tl.amax_of(a), tl.amax_of(b), tl.amax_of(a)]))
    assert float(new.total) == 2 * 32 + 24
