"""Port parity: the serving features of paddle_tpu_torch beside the plain
engine — the bf16 KV pool, batched LoRA banks and their hot swap, the
queue's and the allocator's fault sites, and the dynamic batcher with
``Server(mode="batch")`` — against paddle_tpu on the same numpy weights
(tiny GPT: vocab 97, hidden 64, 2 layers; tiny ERNIE classifier).

- bf16 pool: the port's step casts each KV row to bf16 on write and
  attends in f32, as the reference does, so its tokens equal the
  reference's bf16-pool engine's, at half the pool bytes.
- `lora_logits_delta` for ``[S, H]`` and ``[S, C, H]`` rows within
  1e-6 of the reference's (f32 einsums in another order).
- Adapter-0 slots are bitwise the bank-less engine's (row 0 adds
  exactly 0.0); adapter slots equal the reference's tokens under the
  same bank, in f32 and int8.
- `swap_adapters`: an ``adapter_swap`` fault keeps the old bank bitwise,
  a bad bank is refused, a swap on a running engine lands at a step
  boundary and the next request serves the new bank.
- The dynamic batcher: its ladder, bucket choice and padding equal the
  reference's; `compile_counts` counts each bucket once; a
  ``serving.batch`` fault fails exactly the flush's members.
- ``Server(mode="batch")`` over the tiny ERNIE classifier: each output
  equals the direct forward of its padded bucket bitwise, and the
  reference's forward of the sample within 1e-4 (f32 summed in another
  order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jserving
from paddle_tpu.nlp.transformers.gpt import lora_logits_delta as jdelta
from paddle_tpu.serving import batcher as jbatcher

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.framework import faults
from paddle_tpu_torch.nlp.transformers.gpt import lora_logits_delta
from torch_parity import VOCAB, build_pair, drive, prompt

ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8)
RANK = 4


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    yield
    faults.reset()


def _bank(seed, n=4, hidden=64, vocab=VOCAB, rank=RANK):
    """A seeded adapter bank, row 0 (the base model) all-zero."""
    rng = np.random.RandomState(seed)
    la = (rng.randn(n, rank, hidden) * 0.3).astype(np.float32)
    lb = (rng.randn(n, vocab, rank) * 0.3).astype(np.float32)
    la[0] = 0.0
    lb[0] = 0.0
    return la, lb


def _engine(model, **kw):
    eng = tserving.SlotEngine(model, device="cpu", **ENGINE, **kw)
    eng.warmup()
    return eng


PROMPTS = [prompt(3, 5), prompt(50, 20), prompt(9, 12)]


# -- bf16 KV pool --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16"])
def test_bf16_pool_matches_reference_bf16_pool(pair, dtype):
    jm, tm, _ = pair
    ref = jserving.SlotEngine(jm, cache_dtype=jnp.bfloat16, **ENGINE)
    ref.warmup()
    eng = _engine(tm, cache_dtype=dtype)
    assert eng._ks[0].dtype == torch.bfloat16
    assert eng.kv_pool_bytes == ref.kv_pool_bytes
    assert 2 * eng.kv_pool_bytes == _engine(tm).kv_pool_bytes
    for w, g in zip(drive(ref, PROMPTS, max_new=10),
                    drive(eng, PROMPTS, max_new=10)):
        np.testing.assert_array_equal(g, w)
    assert eng.metrics.get("prefix_hit_tokens") == \
        ref.metrics.get("prefix_hit_tokens")


# -- LoRA ----------------------------------------------------------------------


@pytest.mark.parametrize("cols", [0, 3])
def test_lora_logits_delta_matches_reference(cols):
    rng = np.random.RandomState(cols)
    la, lb = _bank(1, n=3, hidden=16, vocab=11)
    shape = (4, cols, 16) if cols else (4, 16)
    h = rng.randn(*shape).astype(np.float32)
    aid = np.array([0, 2, 1, 2], np.int32)
    got = lora_logits_delta(torch.from_numpy(h), torch.from_numpy(aid).long(),
                            torch.from_numpy(la), torch.from_numpy(lb))
    want = np.asarray(jdelta(h, aid, la, lb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the base row adds exactly zero
    assert not got[0].any()


def test_adapter_zero_slots_bitwise_bankless(pair):
    _, tm, _ = pair
    la, lb = _bank(2)
    want = drive(_engine(tm, quantize=True), PROMPTS, max_new=8)
    eng = _engine(tm, quantize=True, max_adapters=4, lora_rank=RANK)
    eng.swap_adapters(la, lb)
    got = drive(eng, PROMPTS, max_new=8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert eng.metrics.snapshot()["gauges"]["max_adapters"] == 4.0


@pytest.mark.parametrize("leg", ["f32", "int8"])
def test_adapter_slots_match_reference(pair, leg):
    jm, tm, _ = pair
    kw = dict(quantize=True) if leg == "int8" else {}
    la, lb = _bank(3)
    ref = jserving.SlotEngine(jm, max_adapters=4, lora_rank=RANK,
                              **ENGINE, **kw)
    ref.warmup()
    ref.swap_adapters(la, lb)
    eng = _engine(tm, max_adapters=4, lora_rank=RANK, **kw)
    eng.swap_adapters(la, lb)
    gens = [dict(adapter_id=a) for a in (1, 2, 3)]
    want = drive(ref, PROMPTS, max_new=8, gens=gens)
    got = drive(eng, PROMPTS, max_new=8, gens=gens)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # the adapters changed what the base model says
    base = drive(_engine(tm, **kw), PROMPTS, max_new=8)
    assert any(not np.array_equal(b, g) for b, g in zip(base, got))
    with pytest.raises(ValueError, match="adapter_id"):
        eng.submit(prompt(4, 5), adapter_id=4)


def test_swap_adapters_fault_keeps_old_bank_and_swaps_at_boundary(pair):
    _, tm, _ = pair
    la, lb = _bank(4)
    eng = _engine(tm, max_adapters=4, lora_rank=RANK)
    assert eng.swap_adapters(la, lb) == 1
    old_a, old_b = eng._lora_a.clone(), eng._lora_b.clone()
    before = drive(eng, PROMPTS[:1], max_new=6,
                   gens=[dict(adapter_id=2)])[0]
    la2, lb2 = _bank(5)
    with faults.ChaosSchedule("serving.adapter_swap@1:raise") as chaos:
        with pytest.raises(faults.FaultError):
            eng.swap_adapters(la2, lb2)
        chaos.verify()
    assert torch.equal(eng._lora_a, old_a) and torch.equal(eng._lora_b, old_b)
    assert eng.adapter_version == 1
    np.testing.assert_array_equal(
        drive(eng, PROMPTS[:1], max_new=6, gens=[dict(adapter_id=2)])[0],
        before)
    bad = la2.copy()
    bad[0] = 1.0
    with pytest.raises(ValueError, match="row 0"):
        eng.swap_adapters(bad, lb2)
    with pytest.raises(ValueError, match="shapes"):
        eng.swap_adapters(la2[:, :2], lb2)
    # a running engine swaps at a step boundary; requests in flight
    # complete and the next request serves the new bank
    eng.start()
    try:
        futs = [eng.submit(p, max_new_tokens=12, timeout=60.0,
                           adapter_id=i % 4) for i, p in enumerate(PROMPTS)]
        assert eng.swap_adapters(la2, lb2, version=7) == 7
        p = prompt(12, 9)
        after = eng.submit(p, max_new_tokens=6, timeout=60.0, adapter_id=3)
        for f in futs:
            assert np.asarray(f.result(60)).size > 0
        after = np.asarray(after.result(60))
    finally:
        eng.shutdown()
    assert eng.metrics.get("failed") == 0
    assert eng.metrics.get("adapter_swaps") == 2
    fresh = _engine(tm, max_adapters=4, lora_rank=RANK)
    fresh.swap_adapters(la2, lb2)
    np.testing.assert_array_equal(
        after, drive(fresh, [p], max_new=6, gens=[dict(adapter_id=3)])[0])


# -- the queue's and the allocator's fault sites --------------------------------


def test_submit_drop_sheds_and_dequeue_fires_per_request(pair):
    _, tm, _ = pair
    eng = _engine(tm)
    with faults.ChaosSchedule("serving.submit@2:drop") as chaos:
        eng.submit(PROMPTS[0], max_new_tokens=4)
        with pytest.raises(tserving.QueueFullError, match="injected"):
            eng.submit(PROMPTS[1], max_new_tokens=4)
        chaos.verify()
    assert eng.metrics.get("rejected_queue_full") == 1
    with faults.ChaosSchedule("serving.dequeue@1-:delay:0") as chaos:
        outs = drive(eng, PROMPTS[1:], max_new=4)
        # the request queued before the schedule, then the two new ones
        assert chaos.fired()["serving.dequeue"] == 3
    assert [o.size for o in outs] == [24, 16]


def test_alloc_and_cow_faults_fail_admission_leak_free(pair):
    _, tm, _ = pair
    eng = _engine(tm)
    base = prompt(7, 20)
    twin = base.copy()
    twin[12:] = prompt(8, 8)       # diverges inside the second block
    want = drive(_engine(tm), [base, twin], max_new=6)
    drive(eng, [base], max_new=6)
    with faults.ChaosSchedule("serving.cow_split@1:raise") as chaos:
        fut = eng.submit(twin, max_new_tokens=6, timeout=None)
        eng._admit()
        chaos.verify()
    with pytest.raises(faults.FaultError):
        fut.result(1)
    assert eng.active == 0 and eng.blocks_in_use == len(eng._cache)
    with faults.ChaosSchedule("serving.alloc_block@2:raise") as chaos:
        fut = eng.submit(prompt(9, 30), max_new_tokens=6, timeout=None)
        eng._admit()
        chaos.verify()
    with pytest.raises(faults.FaultError):
        fut.result(1)
    assert eng.active == 0 and eng.blocks_in_use == len(eng._cache)
    np.testing.assert_array_equal(drive(eng, [twin], max_new=6)[0], want[1])
    assert eng.metrics.get("cow_splits") == 1


# -- dynamic batcher and batch mode --------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 5, 8, 32])
def test_batcher_ladder_and_padding_match_reference(max_batch):
    ladder = tserving.bucket_ladder(max_batch)
    assert ladder == jbatcher.bucket_ladder(max_batch)
    for n in range(1, max_batch + 1):
        assert tserving.bucket_for(n, ladder) == jbatcher.bucket_for(n, ladder)
    with pytest.raises(ValueError):
        tserving.bucket_for(max_batch + 1, ladder)
    rng = np.random.RandomState(max_batch)
    samples = [rng.randn(3) for _ in range(max(1, max_batch - 1))]
    b = tserving.bucket_for(len(samples), ladder)
    np.testing.assert_array_equal(tserving.pad_batch(samples, b),
                                  jbatcher.pad_batch(samples, b))


def test_batcher_counts_buckets_and_fails_a_faulted_flush():
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return {"double": torch.from_numpy(x) * 2, "rows": x[:, :1]}

    bat = tserving.DynamicBatcher(fn, max_batch=8, max_wait_s=0.05,
                                  metrics=tserving.ServingMetrics())
    assert bat.warmup(np.zeros(3)) == {1: 1, 2: 1, 4: 1, 8: 1}
    outs = bat.run_batch([np.full(3, i, np.float64) for i in range(3)])
    assert seen[-1] == 4 and bat.compile_counts[4] == 1
    np.testing.assert_array_equal(outs[2]["double"], np.full(3, 4.0))
    np.testing.assert_array_equal(outs[1]["rows"], [1.0])
    doomed = [bat.submit(np.full(3, i, np.float64)) for i in range(3)]
    with faults.ChaosSchedule("serving.batch@1:raise") as chaos:
        bat.start()
        for f in doomed:
            with pytest.raises(faults.FaultError):
                f.result(10)
        chaos.verify()
    ok = bat.submit(np.ones(3))
    np.testing.assert_array_equal(ok.result(10)["double"], np.full(3, 2.0))
    bat.close()
    assert bat.metrics.get("failed") == 3 and bat.metrics.get("completed") == 1


def _classifier_pair():
    import paddle_tpu as paddle
    from paddle_tpu.engine import state_values
    from paddle_tpu.nlp.transformers import ErnieConfig
    from paddle_tpu.nlp.transformers import ErnieForSequenceClassification

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import ernie as ternie
    from torch_parity import ERNIE_TINY, random_values

    jm = ErnieForSequenceClassification(ErnieConfig(**ERNIE_TINY),
                                        num_classes=2)
    jm.eval()
    shapes = [(k, tuple(v.shape)) for k, v in state_values(jm).items()]
    vals = random_values(shapes, 3)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = ternie.ErnieForSequenceClassification(
        ternie.ErnieConfig(**ERNIE_TINY), num_classes=2, device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    tm.eval()
    return jm, tm


def test_server_batch_mode_ernie_classifier():
    import paddle_tpu as paddle

    jm, tm = _classifier_pair()
    batches = []

    def classify(x):
        out = tm(torch.from_numpy(x).long())
        batches.append((x.copy(), out.detach().clone()))
        return out

    rng = np.random.RandomState(0)
    samples = [rng.randint(1, VOCAB, (16,)) for _ in range(12)]
    with tserving.Server(mode="batch", fn=classify, max_batch=8,
                         max_wait_s=0.05) as srv:
        assert srv.batcher.warmup(samples[0]) == {1: 1, 2: 1, 4: 1, 8: 1}
        futs = [srv.submit(s) for s in samples]
        outs = [f.result(60) for f in futs]
        snap = srv.snapshot()
    assert snap["counters"]["completed"] == len(samples)
    for s, o in zip(samples, outs):
        # the flush that served the sample, re-run directly: bitwise
        x, y = next((x, y) for x, y in batches[4:]
                    if any(np.array_equal(r, s) for r in x))
        i = next(i for i, r in enumerate(x) if np.array_equal(r, s))
        with torch.no_grad():
            again = tm(torch.from_numpy(x).long())
        assert torch.equal(again, y)
        np.testing.assert_array_equal(o, y[i].numpy())
        want = jm(paddle.to_tensor(s[None].astype(np.int64))).numpy()[0]
        np.testing.assert_allclose(o, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="callable"):
        tserving.Server(mode="batch")
    with pytest.raises(ValueError, match="mode"):
        tserving.Server(tm, mode="stream")
