"""Port parity: low-precision training (``FLAGS_lowp_matmul`` int8 /
fp8 with delayed scaling) through paddle_tpu_torch's `Engine` against
paddle_tpu's, on the tiny ERNIE of `torch_parity` (2 layers, hidden 64)
with the same numpy weights, AdamW, dropout 0, the fused LM-head loss on
(its default: the forward quantizes each vocab chunk, the backward stays
full precision).

- 3 steps in f32 and under bf16 O1: losses and every ScaleState leaf
  against the reference's. The quantized products are exact given
  their codes (tests/test_torch_lowp.py holds them bitwise); what
  differs is the f32 / bf16 arithmetic between the matmuls, summed in
  other orders, and where that noise moves an operand across a rounding
  boundary, its code flips. int8: losses within rtol 2e-3 and the amax
  history and scales within 1e-4 (most runs agree to 2e-7; one int8
  flip, with 5 slots, moved the third loss by 7.3e-4 and the history by
  7.4e-6). fp8: e4m3 keeps 3 mantissa bits, so a flip changes an element
  by up to 1/8: losses within 1e-2 and history / scales within 2e-2
  (measured in f32: 1.5e-3 and 4.2e-3). ``step``, ``updates``,
  ``clipped`` and ``total`` are equal.
- A port engine resumed after step 2 from the reference's parameters,
  AdamW moments and ScaleState (`weights.from_paddle_tpu_scale_state`)
  continues the reference's trajectory.
- ``recompute=True``: the recomputed blocks hide the region, so only the
  heads' 3 linears bind slots, on both sides.
- The anomaly guard keeps the previous ScaleState on a step whose
  gradients are non-finite (an inf input) and on one with a NaN loss.
- With ``FLAGS_lowp_slots`` below the need, the extra operands take
  dynamic scales on both sides.
- Flag off: the trajectory is bitwise the same before and after a
  low-precision run, and no ``lowp.*`` stat moves.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.framework import flags as jflags
from paddle_tpu.nlp.transformers import ErniePretrainingCriterion as JCrit

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.engine import LOWP_SCALE_KEY
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.nlp.transformers import ernie as ternie
from paddle_tpu_torch.quantization import ScaleState
from torch_parity import ERNIE_TINY, VOCAB, build_ernie_pair

LR, STEPS, RESUME_AT = 1e-3, 3, 2
_FLAGS = ["FLAGS_lowp_matmul", "FLAGS_lowp_slots", "FLAGS_use_fused_lm_loss"]
# (losses rtol, history / scale rtol) per mode, as the docstring derives
TOL = {"int8": (2e-3, 1e-4), "fp8": (1e-2, 2e-2)}


@pytest.fixture
def lowp():
    """Set FLAGS_lowp_matmul (and any extra flags) on both packages for
    one test; the fused loss on, its default."""
    saved = (jflags.get_flags(_FLAGS), tflags.get_flags(_FLAGS))

    def both(mode, **extra):
        values = {"FLAGS_lowp_matmul": mode, "FLAGS_use_fused_lm_loss": True,
                  **extra}
        jflags.set_flags(values)
        tflags.set_flags(values)
    yield both
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    types = rng.randint(0, 2, (b, s)).astype(np.int32)
    mlm = ids.copy()
    mlm[rng.rand(b, s) > 0.3] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return (ids, types), (mlm, nsp)


def _state_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _jax_run(amp_on, steps=STEPS, **cfg):
    """Losses of the reference's steps, its parameters, AdamW state and
    ScaleState after step RESUME_AT, and its final ScaleState."""
    jm, _, vals = build_ernie_pair(seed=0, **cfg)
    crit = JCrit()
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters(),
                                 weight_decay=0.01)
    eng = JEngine(jm, opt, lambda out, mlm, nsp: crit(out[0], out[1], mlm,
                                                      nsp))
    inputs, labels = _batch()
    losses, mid = [], None
    for i in range(steps):
        with jamp.auto_cast(enable=amp_on, dtype="bfloat16"):
            losses.append(float(np.asarray(
                eng.train_batch(inputs, labels)._value)))
        if i + 1 == RESUME_AT:
            mid = ({k: np.array(v) for k, v in eng.state.params.items()},
                   {k: {n: np.array(a) for n, a in st.items()}
                    for k, st in eng.state.opt_state.items()},
                   _state_np(eng.state.buffers[LOWP_SCALE_KEY]))
    return vals, losses, mid, _state_np(eng.state.buffers[LOWP_SCALE_KEY])


def _torch_engine(vals, **cfg):
    tm = ternie.ErnieForPretraining(
        ternie.ErnieConfig(**dict(ERNIE_TINY, **cfg)), device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    crit = ternie.ErniePretrainingCriterion()
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters(),
                     weight_decay=0.01)
    return TEngine(tm, opt, lambda out, mlm, nsp: crit(out[0], out[1], mlm,
                                                       nsp), device="cpu")


def _torch_run(eng, amp_on, steps=STEPS):
    inputs, labels = _batch()
    losses = []
    for _ in range(steps):
        with tamp.auto_cast(enable=amp_on, dtype="bfloat16"):
            losses.append(float(eng.train_batch(inputs, labels)))
    return losses


def _assert_state_close(got, want, rtol):
    got = {k: v.numpy() for k, v in got._asdict().items()}
    assert set(got) == set(want)
    for k in ("step", "updates", "clipped", "total"):
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("history", "scale"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_ernie_engine_matches_reference(lowp, mode, amp_on):
    lowp(mode)
    vals, jlosses, _, jstate = _jax_run(amp_on)
    eng = _torch_engine(vals)
    before = tmonitor.stat_get(f"lowp.matmuls_{mode}")
    tlosses = _torch_run(eng, amp_on)
    loss_rtol, state_rtol = TOL[mode]
    np.testing.assert_allclose(tlosses, jlosses, rtol=loss_rtol)
    assert tlosses[-1] < tlosses[0]
    tstate = eng.state.buffers[LOWP_SCALE_KEY]
    assert isinstance(tstate, ScaleState)
    _assert_state_close(tstate, jstate, state_rtol)
    # 2 layers x 4 linears + transform, pooler, NSP: 11 routed linears and
    # one fused-loss forward a step, 22 slots bound
    assert tmonitor.stat_get(f"lowp.matmuls_{mode}") - before == 12 * STEPS
    assert int((tstate.history.amax(1) > 0).sum()) == 22


def test_resume_from_reference_scale_state(lowp):
    lowp("int8")
    _, jlosses, (params, opt_state, scale_state), jstate = _jax_run(False)
    eng = _torch_engine(params)
    weights.from_paddle_tpu_opt_state(opt_state, eng)
    weights.from_paddle_tpu_scale_state(scale_state, eng)
    assert int(eng.state.buffers[LOWP_SCALE_KEY].step) == RESUME_AT
    tlosses = _torch_run(eng, False, 1)
    np.testing.assert_allclose(tlosses, jlosses[RESUME_AT:],
                               rtol=TOL["int8"][0])
    _assert_state_close(eng.state.buffers[LOWP_SCALE_KEY], jstate,
                        TOL["int8"][1])
    with pytest.raises(ValueError, match="shape"):
        weights.from_paddle_tpu_scale_state(
            dict(scale_state, scale=np.ones(3, np.float32)), eng)


def test_recompute_hides_the_region(lowp):
    lowp("int8")
    vals, jlosses, _, jstate = _jax_run(False, recompute=True)
    eng = _torch_engine(vals, recompute=True)
    tlosses = _torch_run(eng, False)
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL["int8"][0])
    tstate = eng.state.buffers[LOWP_SCALE_KEY]
    _assert_state_close(tstate, jstate, TOL["int8"][1])
    # only the heads (transform, pooler, NSP) bind slots
    assert int((tstate.history.amax(1) > 0).sum()) == 6
    assert int((jstate["history"].max(1) > 0).sum()) == 6


class _JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(4, 8)
        self.fc2 = paddle.nn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(self.fc1(x))


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(4, 8)
        self.fc2 = tnn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(self.fc1(x))


def test_guard_keeps_the_scale_state_on_bad_steps(lowp):
    """Step 1's batch holds an inf (its amax poisons the history, its
    gradients are non-finite), step 2 adds a NaN loss term: the guard
    skips both and keeps the ScaleState of the step before, on both
    sides."""
    lowp("int8")
    rng = np.random.RandomState(0)
    vals = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ("fc1.weight", (4, 8)), ("fc1.bias", (8,)), ("fc2.weight", (8, 3)),
        ("fc2.bias", (3,)))}
    jm = _JNet()
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = _TNet()
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in vals.items()})
    jeng = JEngine(jm, paddle.optimizer.AdamW(learning_rate=0.05,
                                              parameters=jm.parameters()),
                   lambda out, y, z: paddle.mean((out - y) * (out - y)) +
                   paddle.sum(z), anomaly_guard=True)
    teng = TEngine(tm, topt.AdamW(learning_rate=0.05),
                   lambda out, y, z: ((out - y) * (out - y)).mean() + z.sum(),
                   anomaly_guard=True, device="cpu")
    prev = None
    for i in range(4):
        x = rng.randn(8, 4).astype(np.float32)
        z = np.zeros((2,), np.float32)
        if i == 1:
            x[3, 2] = np.inf
        if i == 2:
            z[1] = np.nan
        y = rng.randn(8, 3).astype(np.float32)
        jloss = float(np.asarray(jeng.train_batch(x, (y, z))._value))
        tloss = float(teng.train_batch(x, (y, z)))
        np.testing.assert_allclose(tloss, jloss, rtol=TOL["int8"][0])
        tstate = teng.state.buffers[LOWP_SCALE_KEY]
        _assert_state_close(tstate, _state_np(
            jeng.state.buffers[LOWP_SCALE_KEY]), TOL["int8"][1])
        if i in (1, 2):
            for new, old in zip(tstate, prev):
                assert torch.equal(new, old)
        prev = tstate
    assert int(prev.step) == 2 and teng.anomaly_bad_steps.item() == 0


def test_slot_overflow_takes_dynamic_scales(lowp):
    lowp("int8", FLAGS_lowp_slots=5)
    vals, jlosses, _, jstate = _jax_run(False)
    before = tmonitor.stat_get("lowp.slot_overflow")
    eng = _torch_engine(vals)
    tlosses = _torch_run(eng, False)
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL["int8"][0])
    _assert_state_close(eng.state.buffers[LOWP_SCALE_KEY], jstate,
                        TOL["int8"][1])
    assert eng.state.buffers[LOWP_SCALE_KEY].scale.shape == (5,)
    # 22 operands a step, 5 slots: 17 overflow a step
    assert tmonitor.stat_get("lowp.slot_overflow") - before == 17 * STEPS


def test_flag_off_is_bitwise_unchanged(lowp):
    _, _, vals = build_ernie_pair(seed=0)

    def run(mode):
        lowp(mode)
        eng = _torch_engine(vals)
        stats = tmonitor.stats("lowp.")
        losses = _torch_run(eng, True)
        params = {k: p.detach().clone() for k, p in eng.state.params.items()}
        return losses, params, stats, tmonitor.stats("lowp."), eng

    off1, p1, s0, s1, eng = run("off")
    assert LOWP_SCALE_KEY not in eng.state.buffers
    assert s1 == s0
    low, _, _, _, _ = run("int8")
    assert low != off1
    off2, p2, s2, s3, _ = run("off")
    assert s3 == s2
    assert off2 == off1
    for k, v in p1.items():
        assert torch.equal(p2[k], v), k
