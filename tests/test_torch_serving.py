"""Port parity: paddle_tpu_torch's `SlotEngine` (device="cpu") against
paddle_tpu's in three legs — f32, int8 (``quantize=True``) and w8a8
(``quantize=True, w8a8=True``) — on the same weights and pinned prompts:
three plain prompts, a shared-prefix pair served one after the other
(prefix-cache reuse plus a copy-on-write split) and one sampled request
(host-side numpy sampling in both engines).

Greedy tokens must be equal. A token flips legitimately only where two
logits tie to within the f32 summation-order noise, after which the
sequences diverge; so each greedy request is compared up to its first
emitted position whose reference top-2 logit margin is <= 1e-4, and the
test asserts that nearly all positions get compared. The w8a8
activation scale must freeze after the same number of steps at the same
value. On the CPU the heads run the kernels' plain versions, so instead
of launch counts the test checks that the head went through
`dequant_matmul` / `w8a8_matmul`.
"""

from __future__ import annotations

import numpy as np
import pytest

from paddle_tpu import serving as jserving

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.ops import lowp as tlowp
from paddle_tpu_torch.ops import quant_ops as tquant
from torch_parity import build_pair, drive, prompt

MARGIN = 1e-4
ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8)
LEGS = {"f32": {}, "int8": dict(quantize=True),
        "w8a8": dict(quantize=True, w8a8=True)}


class _MarginEngine(jserving.SlotEngine):
    """The reference engine, recording each greedy pick's top-2 margin
    per request."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.margins = {}

    def _pick(self, slot):
        top2 = np.sort(slot.next_logits)[-2:]
        self.margins.setdefault(slot.req.id, []).append(
            float(top2[1] - top2[0]))
        return super()._pick(slot)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


def _workload():
    base = prompt(7, 20)
    twin = base.copy()
    twin[12:] = prompt(8, 8)       # diverges inside the second block
    plain = [prompt(3, 5), prompt(50, 20), prompt(9, 12)]
    return plain, base, twin


def _serve(eng):
    plain, base, twin = _workload()
    outs = drive(eng, plain, max_new=10)
    outs += drive(eng, [base], max_new=8)      # fills the prefix cache
    outs += drive(eng, [twin], max_new=8)      # reuse + copy-on-write
    outs += drive(eng, [prompt(11, 6)], max_new=10,
                  gens=[dict(do_sample=True, temperature=0.8, top_k=20,
                             seed=5)])
    return outs


def _compare(ref_eng, want, got, n_prompt):
    """Equal tokens up to each greedy request's first near-tie; the
    sampled (last) request is compared whole."""
    ids = sorted(ref_eng.margins)
    compared = total = 0
    for j, (w, g, n) in enumerate(zip(want, got, n_prompt)):
        w, g = w[n:], g[n:]
        assert w.shape == g.shape
        stop = w.size
        if j < len(want) - 1:
            near = [i for i, m in enumerate(ref_eng.margins[ids[j]])
                    if m <= MARGIN]
            stop = near[0] if near else w.size
        np.testing.assert_array_equal(g[:stop], w[:stop], err_msg=str(j))
        compared += stop
        total += w.size
    assert compared >= 0.9 * total, (compared, total)


@pytest.mark.parametrize("leg", list(LEGS))
def test_slot_engine_matches_reference(pair, monkeypatch, leg):
    jm, tm, _ = pair
    calls = {"dequant_matmul": 0, "w8a8_matmul": 0}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(tquant, "dequant_matmul")
    spy(tlowp, "w8a8_matmul")
    ref = _MarginEngine(jm, **ENGINE, **LEGS[leg])
    ref.warmup()
    eng = tserving.SlotEngine(tm, device="cpu", **ENGINE, **LEGS[leg])
    eng.warmup()
    want, got = _serve(ref), _serve(eng)
    plain, base, twin = _workload()
    n_prompt = [p.size for p in plain] + [base.size, twin.size, 6]
    _compare(ref, want, got, n_prompt)
    for name in ("prefix_hit_tokens", "cow_splits", "steps", "completed",
                 "tokens_out"):
        assert eng.metrics.get(name) == ref.metrics.get(name), name
    assert eng.metrics.get("cow_splits") >= 1
    assert eng.metrics.get("failed") == 0
    steps = eng.metrics.get("steps")
    if leg == "f32":
        assert calls == {"dequant_matmul": 0, "w8a8_matmul": 0}
    elif leg == "int8":
        # warmup + every step ran the int8 head
        assert calls == {"dequant_matmul": steps + 1, "w8a8_matmul": 0}
    else:
        # warmup absorbed one abs-max: B7 there, B8 on every real step
        assert calls == {"dequant_matmul": 1, "w8a8_matmul": steps}
        assert eng._act_frozen and ref._act_frozen
        assert eng._act_calib == ref._act_calib
        np.testing.assert_allclose(float(eng._act_scale),
                                   float(ref._act_scale), rtol=1e-6)


def test_server_generate_threaded(pair):
    """The threaded Server front: concurrent requests complete with the
    same greedy tokens as the synchronous engine (int8 rows are
    independent of their batch)."""
    _, tm, _ = pair
    prompts = [prompt(s, 9) for s in (21, 22, 23)]
    want = drive(tserving.SlotEngine(tm, device="cpu", quantize=True,
                                     **ENGINE), prompts, max_new=6)
    with tserving.Server(tm, device="cpu", quantize=True,
                         **ENGINE) as srv:
        futs = [srv.submit(p, max_new_tokens=6, timeout=60.0)
                for p in prompts]
        got = [np.asarray(f.result(60.0)) for f in futs]
        snap = srv.snapshot()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert snap["counters"]["completed"] == 3
    assert snap["gauges"]["dequant_path"] == 1.0
    assert snap["latency_s"]["step"]["count"] == snap["counters"]["steps"]
    with pytest.raises(ValueError, match="max_seq_len"):
        srv.engine.submit(np.ones(60, np.int32), max_new_tokens=10)
    with pytest.raises(tserving.CapacityExhaustedError):
        tserving.SlotEngine(tm, device="cpu", num_blocks=3,
                            **ENGINE).submit(np.ones(20, np.int32))


def test_prefrozen_int8_values_are_adopted(pair):
    """A reference-frozen int8 state dict crosses by `weights`: the
    model gets its canonical dequant, and an engine handed the int8
    dict serves exactly like one that froze the float weights itself."""
    from paddle_tpu.quantization import (
        dequantize_state, quantize_state_int8,
    )

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt
    from torch_parity import TINY

    _, tm, vals = pair
    frozen = quantize_state_int8(vals)
    model = tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY), device="cpu")
    tvals = weights.from_paddle_tpu_values(frozen, model)
    emb = "gpt.embeddings.word_embeddings.weight"
    np.testing.assert_array_equal(
        model.state_dict()[emb].numpy(),
        np.asarray(dequantize_state(frozen)[emb]))
    adopted = tserving.SlotEngine(model, device="cpu", values=tvals,
                                  **ENGINE)
    assert adopted.quantized and adopted._head_key is not None
    own = tserving.SlotEngine(tm, device="cpu", quantize=True, **ENGINE)
    prompts = [prompt(s, 10) for s in (31, 32)]
    for a, b in zip(drive(adopted, prompts), drive(own, prompts)):
        np.testing.assert_array_equal(a, b)


def test_engine_sheds_cancels_and_expires(pair):
    """The admission contract: a full queue sheds with a 429, a request
    cancelled mid-decode and one whose deadline passes are evicted at
    the next step with their typed errors, a non-drain shutdown fails
    what is still queued — and the engine keeps serving."""
    import time

    _, tm, _ = pair
    eng = tserving.SlotEngine(
        tm, device="cpu", queue=tserving.AdmissionQueue(3), **ENGINE)
    ok = eng.submit(prompt(41, 6), max_new_tokens=8, timeout=None)
    gone = eng.submit(prompt(42, 6), max_new_tokens=8, timeout=None)
    late = eng.submit(prompt(43, 6), max_new_tokens=8, timeout=30.0)
    with pytest.raises(tserving.QueueFullError):
        eng.submit(prompt(44, 6), max_new_tokens=8)
    eng._admit()                       # two slots: ok + gone; late waits
    eng._step()
    gone.cancel()
    late.deadline = time.monotonic() - 1.0
    while eng.active:
        eng._step()
        eng._admit()
    assert np.asarray(ok.result(1)).shape == (14,)
    with pytest.raises(tserving.RequestCancelled):
        gone.result(1)
    with pytest.raises(tserving.DeadlineExceededError):
        late.result(1)
    queued = eng.submit(prompt(45, 6), max_new_tokens=8, timeout=None)
    eng.shutdown(drain=False)
    with pytest.raises(tserving.ServerClosedError):
        queued.result(1)
    assert eng.metrics.get("completed") == 1
    # no block leaked: only the prefix cache still holds any
    assert eng._alloc.blocks_in_use == len(eng._cache)
