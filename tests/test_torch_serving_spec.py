"""Port parity: speculative decoding in paddle_tpu_torch's `SlotEngine`
(device="cpu") against plain greedy and against paddle_tpu's spec
engine, on the tiny GPT of tests/torch_parity.py (vocab 97, hidden 64,
2 layers).

- `speculative_accept` is pure numpy over a `RandomState`: the port's
  copy returns exactly the reference's (accepted count, resampled
  token) on the same inputs and generator state, and passes the
  reference's histogram check (total variation < 0.02 over 40000 draws).
- Greedy speculative decode is bitwise the plain engine's greedy
  tokens, self-draft (k = 1 and 3, acceptance exactly 1.0) and with a
  1-layer draft (acceptance strictly between 0 and 1), in f32 and int8.
- Against the reference's spec engine on the same weights, f32 and
  int8: equal tokens and equal drafted / accepted counts. The tiny
  model has no near-tie on these prompts, so the whole sequences are
  compared.
- The fault sites of the step: ``serving.draft`` degrades one round to
  plain decode with no lost or duplicated token, ``serving.verify`` and
  ``serving.step`` fail the in-flight requests while the engine keeps
  serving, ``serving.dequant`` fires once per step of an int8 engine,
  and ``serving.w8a8`` degrades one step to the weights-only head.
"""

from __future__ import annotations

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving.engine import speculative_accept as jaccept

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.framework import faults
from paddle_tpu_torch.ops import quant_ops as tquant
from torch_parity import build_pair, drive, prompt

ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8)
CASES = [(prompt(3, 5), 7), (prompt(50, 29), 6), (prompt(9, 12), 9)]


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.fixture(scope="module")
def draft():
    """A 1-layer draft over the same vocabulary, other weights."""
    return build_pair(seed=5, num_layers=1)[1]


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    yield
    faults.reset()


def _engine(model, **kw):
    eng = tserving.SlotEngine(model, device="cpu", **ENGINE, **kw)
    eng.warmup()
    return eng


def _serve(eng, cases=CASES):
    """One request at a time, so every engine sees the same batches."""
    return [drive(eng, [p], max_new=n)[0] for p, n in cases]


def _drive_caught(eng, p, max_new):
    """`drive` with the serve loop's contract: a step error fails every
    in-flight request and the engine stays up."""
    fut = eng.submit(p, max_new_tokens=max_new, timeout=None)
    eng._admit()
    while eng.active:
        try:
            eng._step()
        except Exception as e:  # noqa: BLE001 — _loop parity
            eng.metrics.inc("step_errors")
            eng._fail_all_active(e)
    return fut


def test_speculative_accept_bitwise_and_histogram():
    v = 13
    rng = np.random.RandomState(0)
    cases = []
    for _ in range(200):
        s = int(rng.randint(1, 4))
        p = [rng.dirichlet(np.ones(v)) for _ in range(s)]
        q = [rng.dirichlet(np.ones(v)) for _ in range(s)]
        d = [int(rng.choice(v, p=qi)) for qi in q]
        cases.append((p, q, d))
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    for p, q, d in cases:
        assert tserving.speculative_accept(p, q, d, a) == jaccept(p, q, d, b)
    assert np.array_equal(a.random_sample(4), b.random_sample(4))
    # the reference's histogram: accepted-or-resampled tokens from
    # (p, q) pairs distribute as p
    p = rng.dirichlet(np.ones(v))
    q = rng.dirichlet(np.ones(v))
    n = 40000
    counts = np.zeros(v)
    for _ in range(n):
        d = int(rng.choice(v, p=q))
        acc, resampled = tserving.speculative_accept([p], [q], [d], rng)
        counts[d if acc == 1 else resampled] += 1
    assert 0.5 * np.abs(counts / n - p).sum() < 0.02
    # degenerate residual (p == q at the proposal) falls back to p
    assert tserving.speculative_accept(
        [p], [p], [3], np.random.RandomState(1)) == (1, None)


@pytest.mark.parametrize("leg", ["f32", "int8"])
@pytest.mark.parametrize("k", [1, 3])
def test_spec_self_draft_is_plain_greedy_bitwise(pair, leg, k):
    _, tm, _ = pair
    kw = dict(quantize=True) if leg == "int8" else {}
    want = _serve(_engine(tm, **kw))
    spec = _engine(tm, spec_len=k, **kw)
    for w, g in zip(want, _serve(spec)):
        np.testing.assert_array_equal(g, w)
    snap = spec.metrics.snapshot()["speculative"]
    assert snap["drafted_tokens"] > 0 and snap["rejected_tokens"] == 0
    assert snap["acceptance_rate"] == 1.0
    assert spec.prefill_chunk == max(ENGINE["prefill_chunk"], k + 1)


def test_spec_one_layer_draft_is_plain_greedy_bitwise(pair, draft):
    """A real (weaker) draft: rejections cost speed, never tokens."""
    _, tm, _ = pair
    cases = [(prompt(s, 7), 8) for s in (21, 22, 23)]
    want = _serve(_engine(tm), cases)
    spec = _engine(tm, spec_len=3, draft_model=draft)
    for w, g in zip(want, _serve(spec, cases)):
        np.testing.assert_array_equal(g, w)
    rate = spec.metrics.snapshot()["speculative"]["acceptance_rate"]
    assert 0.0 < rate < 1.0
    # the draft's pools join the pool bytes
    assert spec.kv_pool_bytes == int(1.5 * _engine(tm).kv_pool_bytes)


@pytest.mark.parametrize("leg", ["f32", "int8"])
def test_spec_engine_matches_reference(pair, monkeypatch, leg):
    jm, tm, _ = pair
    kw = dict(quantize=True) if leg == "int8" else {}
    calls = {"n": 0}
    fn = tquant.dequant_matmul

    def spy(*a, **k):
        calls["n"] += 1
        return fn(*a, **k)

    monkeypatch.setattr(tquant, "dequant_matmul", spy)
    ref = jserving.SlotEngine(jm, spec_len=3, **ENGINE, **kw)
    ref.warmup()
    eng = _engine(tm, spec_len=3, **kw)
    for w, g in zip(_serve(ref), _serve(eng)):
        np.testing.assert_array_equal(g, w)
    for name in ("steps", "spec_rounds", "spec_drafted_tokens",
                 "spec_accepted_tokens", "tokens_out", "completed"):
        assert eng.metrics.get(name) == ref.metrics.get(name), name
    # int8: the head of the last rows and of the k+1 verify columns,
    # both through dequant_matmul, on warmup and every step
    steps = eng.metrics.get("steps")
    assert calls["n"] == (2 * (steps + 1) if leg == "int8" else 0)


def test_draft_fault_degrades_round_to_plain_decode(pair):
    _, tm, _ = pair
    p = prompt(63, 7)
    want = drive(_engine(tm), [p], max_new=9)[0]
    spec = _engine(tm, spec_len=2)
    with faults.ChaosSchedule("serving.draft@2:raise") as chaos:
        got = drive(spec, [p], max_new=9)[0]
        chaos.verify()
    np.testing.assert_array_equal(got, want)
    snap = spec.metrics.snapshot()
    assert snap["speculative"]["draft_faults"] == 1
    assert snap["counters"].get("failed", 0) == 0
    assert snap["speculative"]["accepted_tokens"] > 0


@pytest.mark.parametrize("site", ["serving.verify", "serving.step"])
def test_step_faults_fail_inflight_and_engine_survives(pair, site):
    _, tm, _ = pair
    spec = _engine(tm, spec_len=2)
    schedule = {"serving.verify": faults.ChaosSchedule(
                    "serving.verify@2:raise"),
                "serving.step": faults.ChaosSchedule(
                    "serving.step@2:raise")}[site]
    with schedule as chaos:
        fut = _drive_caught(spec, prompt(70, 6), 8)
        chaos.verify()
    with pytest.raises(faults.FaultError):
        fut.result(1)
    assert spec.metrics.get("failed") == 1
    assert spec._alloc.blocks_in_use == len(spec._cache)
    p = prompt(71, 6)
    want = drive(_engine(tm), [p], max_new=5)[0]
    np.testing.assert_array_equal(drive(spec, [p], max_new=5)[0], want)


def test_dequant_fault_fires_once_per_int8_step(pair):
    _, tm, _ = pair
    eng = _engine(tm, quantize=True)
    with faults.ChaosSchedule("serving.dequant@1-:delay:0") as chaos:
        drive(eng, [prompt(80, 6)], max_new=2)
        # one per step call; the last call only finishes the request
        assert chaos.fired()["serving.dequant"] == \
            eng.metrics.get("steps") + 1
    with faults.ChaosSchedule("serving.dequant@1-:raise") as chaos:
        drive(_engine(tm), [prompt(82, 6)], max_new=3)
        assert chaos.fired()["serving.dequant"] == 0     # float engine
    with faults.ChaosSchedule("serving.dequant@1:raise") as chaos:
        fut = _drive_caught(eng, prompt(81, 6), 4)
        chaos.verify()
    with pytest.raises(faults.FaultError):
        fut.result(1)
    assert eng.metrics.get("step_errors") == 1


def test_w8a8_fault_degrades_one_step_to_weights_only_head(pair,
                                                           monkeypatch):
    from paddle_tpu_torch.ops import lowp as tlowp

    _, tm, _ = pair
    heads = []
    for mod, name in ((tquant, "dequant_matmul"), (tlowp, "w8a8_matmul")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            heads.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    eng = _engine(tm, quantize=True, w8a8=True, spec_len=2)
    assert heads == ["dequant_matmul"] * 2       # warmup, scale at 0
    calib = eng._act_calib
    with faults.ChaosSchedule("serving.w8a8@2:raise") as chaos:
        out = drive(eng, [prompt(90, 6)], max_new=6)[0]
        chaos.verify()
    assert out.shape == (12,)
    steps = eng.metrics.get("steps")
    assert eng.metrics.get("w8a8_degraded_steps") == 1
    # every step projects two row blocks; the degraded one on B7
    assert heads[2:] == (["w8a8_matmul"] * 2 + ["dequant_matmul"] * 2
                         + ["w8a8_matmul"] * 2 * (steps - 2))
    # the degraded step absorbed no abs-max
    assert eng._act_calib == calib + steps - 1
    assert eng.metrics.get("failed") == 0
