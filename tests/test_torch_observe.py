"""Port parity: paddle_tpu_torch.observe (the step timeline and goodput,
the retrace registry and compile counters, the Prometheus / JSON
export) against paddle_tpu.observe, on the CPU.

Every comparison here is exact (string or dict equality), except where
a test says otherwise:

- `signature_of` prints the same string for the same pytree of numpy
  arrays, torch tensors and jax arrays, in float32, bfloat16 and int32;
- `timeline.add` / `aggregates` and `goodput` give equal dicts for the
  same calls;
- three `Engine.train_batch` steps of a 2-layer ERNIE in each package
  record one ``train_step`` event with the same signature, the same
  phase names and call counts; a new sequence length adds one event in
  both; a third shape under `no_retrace()` raises `RetraceError` in
  both before the step runs, and both engines step on afterwards;
- `SlotEngine.compile_counts` of the tiny GPT equals the reference's
  after warm-up and traffic, plain and with ``spec_len=2``, and a
  repeat warm-up passes under `no_retrace()`; the batcher records one
  ``serving.batch`` compile per bucket in both;
- `prometheus_text()` is identical line for line once both packages'
  registries are reset and fed the same `ServingMetrics` calls, monitor
  stats and `timeline.add` values (both clocks frozen), with and without
  a fixed ``fleet=`` snapshot;
- a save and a restore through `CheckpointManager` and
  `AsyncCheckpointManager` record the same phases and counts, and
  goodput books the async write as overlapped;
- `http_front`'s ``/metrics`` negotiates content as the reference's
  does (bare GET JSON, ``Accept: text/plain`` and ``?format=prometheus``
  the exposition, with the same family names as `metrics_prometheus`).
"""

from __future__ import annotations

import json
import re
import time
import urllib.request

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observe as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.nlp.transformers import ErniePretrainingCriterion as JCrit
from paddle_tpu.serving import metrics as jmetrics

from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.nlp.transformers import ernie as ternie
from paddle_tpu_torch.serving import metrics as tmetrics
from torch_parity import (ERNIE_TINY, VOCAB, build_ernie_pair, build_pair,
                          drive, prompt)

FLAG = "FLAGS_use_fused_lm_loss"
ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8)

_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9].*)$")


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' observe registries start and end empty."""
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


# ---------------------------------------------------------------------------
# retrace: signature_of
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_signature_of_matches_reference(dtype):
    rng = np.random.RandomState(0)
    npd = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    a = rng.randn(8, 64).astype(npd)
    b = rng.randn(8).astype(npd)
    c = rng.randn(2, 3, 4).astype(npd)
    tree = {"inputs": (a, [b]), "labels": (c,), "aux": None}
    want = jobs.signature_of(
        {"inputs": (jnp.asarray(a), [jnp.asarray(b)]),
         "labels": (jnp.asarray(c),), "aux": None})
    tdt = getattr(torch, dtype)
    ttree = {"inputs": (torch.zeros(8, 64, dtype=tdt),
                        [torch.zeros(8, dtype=tdt)]),
             "labels": (torch.zeros(2, 3, 4, dtype=tdt),), "aux": None}
    assert tobs.signature_of(tree) == want
    assert tobs.signature_of(ttree) == want
    assert want == f"({dtype}[8, 64], {dtype}[8], {dtype}[2, 3, 4])"
    assert tobs.signature_of(3, "x") == jobs.signature_of(3, "x")


# ---------------------------------------------------------------------------
# timeline and goodput
# ---------------------------------------------------------------------------

_ADDS = (("device-step", 0.25), ("compile", 1.5), ("device-step", 0.5),
         ("checkpoint-snapshot", 0.03), ("checkpoint-write-async", 2.0),
         ("checkpoint-restore", 0.7), ("host-prep", 0.01), ("sample", 0.2),
         ("gang-restart", 0.4), ("mystery", 0.125))


def test_timeline_aggregates_and_goodput_match_reference():
    for name, secs in _ADDS:
        jobs.timeline.add(name, secs)
        tobs.timeline.add(name, secs)
    assert tobs.timeline.aggregates() == jobs.timeline.aggregates()
    assert tobs.timeline.total("device-step") == 0.75
    assert tobs.goodput() == jobs.goodput()
    gp = tobs.goodput()
    assert gp["overlapped_s"] == 2.0
    assert gp["categories_s"]["other"] == 0.125


# ---------------------------------------------------------------------------
# the training engine: phases, one compile per batch signature
# ---------------------------------------------------------------------------


def _ernie_batch(s, b=2, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    types = rng.randint(0, 2, (b, s)).astype(np.int32)
    mlm = ids.copy()
    mlm[rng.rand(b, s) > 0.3] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return (ids, types), (mlm, nsp)


@pytest.fixture
def unfused():
    """The unfused LM head on both sides (the reference's fused one runs
    a Pallas kernel), and the guard's counter read every step."""
    flags = {FLAG: False, "FLAGS_anomaly_check_interval": 1}
    prev = (jflags.get_flags(list(flags)), tflags.get_flags(list(flags)))
    jflags.set_flags(flags)
    tflags.set_flags(flags)
    yield
    jflags.set_flags(prev[0])
    tflags.set_flags(prev[1])


def _engines():
    jm, _, vals = build_ernie_pair(seed=0)
    jcrit = JCrit()
    jeng = JEngine(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()),
        lambda out, mlm, nsp: jcrit(out[0], out[1], mlm, nsp),
        anomaly_guard=True)
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**ERNIE_TINY),
                                    device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    tcrit = ternie.ErniePretrainingCriterion()
    teng = TEngine(tm, topt.AdamW(learning_rate=1e-3,
                                  parameters=tm.parameters()),
                   lambda out, mlm, nsp: tcrit(out[0], out[1], mlm, nsp),
                   device="cpu", anomaly_guard=True)
    return jeng, teng


def _phase_calls(obs):
    return {k: v["calls"] for k, v in obs.timeline.aggregates().items()}


def test_train_step_compiles_once_per_signature_like_reference(unfused):
    jeng, teng = _engines()
    x, y = _ernie_batch(32)
    for _ in range(3):
        jeng.train_batch(x, y)
        teng.train_batch(x, y)
    for obs in (jobs, tobs):
        assert len(obs.compile_events("train_step")) == 1
    assert [e["signature"] for e in tobs.compile_events()] == \
        [e["signature"] for e in jobs.compile_events()]
    assert tobs.compile_events()[0]["signature"] == \
        "(int32[2, 32], int32[2, 32], int32[2, 32], int32[2])"
    assert tobs.compile_events("train_step")[0]["wall_s"] > 0
    calls = _phase_calls(tobs)
    assert calls == _phase_calls(jobs)
    assert calls == {"host-prep": 3, "compile": 1, "device-step": 2,
                     "anomaly-readback": 3}
    # steady state is quiet; a new sequence length is one more compile
    with jobs.no_retrace(), tobs.no_retrace():
        jeng.train_batch(x, y)
        teng.train_batch(x, y)
    x16, y16 = _ernie_batch(16)
    jeng.train_batch(x16, y16)
    teng.train_batch(x16, y16)
    assert [e["signature"] for e in tobs.compile_events()] == \
        [e["signature"] for e in jobs.compile_events()]
    assert len(tobs.compile_events("train_step")) == 2
    # a third shape under the guard raises before the step runs
    x8, y8 = _ernie_batch(8)
    for obs, eng in ((jobs, jeng), (tobs, teng)):
        step = eng.state.step
        with pytest.raises(obs.RetraceError, match="train_step"):
            with obs.no_retrace():
                eng.train_batch(x8, y8)
        assert eng.state.step == step
        loss = eng.train_batch(x, y)
        loss = loss if obs is tobs else np.asarray(loss._value)
        assert np.isfinite(float(loss))
    # the aborted attempt stays in both audits; the step back at the old
    # shape compiles nothing in either (the reference names its phase
    # "compile" all the same: its rule is "another shape than the last
    # step's", the port's "a shape never stepped")
    assert [e["signature"] for e in tobs.compile_events()] == \
        [e["signature"] for e in jobs.compile_events()]
    assert len(tobs.compile_events("train_step")) == 3
    assert _phase_calls(tobs) == {"host-prep": 7, "compile": 3,
                                  "device-step": 4, "anomaly-readback": 6}


# ---------------------------------------------------------------------------
# serving: compile counters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt_pair():
    return build_pair(seed=0)


@pytest.mark.parametrize("spec_len", [0, 2], ids=["plain", "spec2"])
def test_slot_engine_compile_counts_match_reference(gpt_pair, spec_len):
    jm, tm, _ = gpt_pair
    ref = jserving.SlotEngine(jm, spec_len=spec_len, **ENGINE)
    eng = tserving.SlotEngine(tm, device="cpu", spec_len=spec_len,
                              **ENGINE)
    want = ref.warmup()
    assert eng.warmup() == want
    assert want == dict(decode=1, cow=1, **({"draft": 1} if spec_len
                                             else {}))
    # shared prefixes force a copy-on-write split on both sides
    base = prompt(3, 12)
    cases = [base, np.concatenate([base, prompt(4, 5)]), prompt(9, 7)]
    for p in cases:
        drive(ref, [p], max_new=4)
        drive(eng, [p], max_new=4)
    assert eng.metrics.get("cow_splits") == ref.metrics.get("cow_splits")
    assert eng.compile_counts == ref.compile_counts == want
    with tobs.no_retrace():
        assert eng.warmup() == want
    names = sorted(e["name"] for e in tobs.compile_events())
    assert names == sorted(e["name"] for e in jobs.compile_events())


def test_strict_engine_and_batcher_trip_on_new_shapes(gpt_pair):
    _, tm, _ = gpt_pair
    eng = tserving.SlotEngine(tm, device="cpu", strict_shapes=True,
                              **ENGINE)
    eng.warmup()
    eng._bt = np.zeros((2, eng.blocks_per_slot + 1), np.int32)
    with tobs.no_retrace(), pytest.raises(tobs.RetraceError,
                                          match="serving.step"):
        eng._device_step(np.zeros((2, 8), np.int32),
                         np.zeros((2,), np.int32), np.ones((2,), np.int32))
    tb = tserving.DynamicBatcher(lambda x: x * 2, max_batch=4,
                                 strict_shapes=True)
    jb = jserving.DynamicBatcher(lambda x: x * 2, max_batch=4,
                                 strict_shapes=True)
    sample = np.ones((3,), np.float32)
    assert tb.warmup(sample) == jb.warmup(sample) == {1: 1, 2: 1, 4: 1}
    assert len(tobs.compile_events("serving.batch")) == 3
    tb.run_batch([sample] * 3)             # a warmed bucket: no compile
    with pytest.raises(tobs.RetraceError, match="serving.batch"):
        tb.run_batch([np.ones((5,), np.float32)])


# ---------------------------------------------------------------------------
# the Prometheus export
# ---------------------------------------------------------------------------


def _feed(metrics_mod, monitor_mod, obs, monkeypatch):
    """The same registry traffic into one package, clocks frozen."""
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    m = metrics_mod.ServingMetrics()
    for name, n in (("submitted", 5), ("completed", 4), ("tokens_out", 96),
                    ("steps", 30), ("prefill_tokens", 60),
                    ("prefix_lookups", 4), ("prompt_tokens", 80),
                    ("prefix_hit_tokens", 16), ("kv_spilled_blocks", 3),
                    ("spec_drafted_tokens", 12),
                    ("spec_accepted_tokens", 9), ("kv_migrations", 2)):
        m.inc(name, n)
    for v in (0.01, 0.02, 0.05, 0.03):
        m.observe_latency("e2e", v)
        m.observe_latency("step", v / 10)
    m.observe_occupancy(3, 4)
    m.observe_occupancy(4, 4)
    m.observe_blocks(10, 40)
    m.observe_spec(0, 4, 3)
    m.set_gauge("dequant_path", 1.0)
    m.note_role("decode")
    m.tenant_inc("a", "completed", 2)
    m.tenant_inc("a", "tokens_out", 40)
    m.tenant_observe_latency("a", 0.5)
    m.tenant_set_gauge("a", "budget_remaining", 12.5)
    monitor_mod.stat_add("lowp.matmuls_int8", 7)
    monitor_mod.stat_set("fleet.live_replicas", 2)
    monitor_mod.stat_add("fleet.scale_events_up")
    monitor_mod.stat_add("fleet.slo_violation_ms", 1500)
    monitor_mod.stat_add("ckpt_async_saves", 3)
    for name, secs in _ADDS:
        obs.timeline.add(name, secs)
    obs.record_compile("train_step", signature="(x)")
    return m


FLEET_SNAP = {
    "name": "fleet", "live_replicas": 1, "member_replicas": 2,
    "brownout": False, "in_flight": 3,
    "replicas": [
        {"name": "fleet.r0", "state": "healthy", "restarts": 1,
         "deaths": 1, "heartbeats": 120, "load": 2, "uptime_s": 12.5,
         "beat_age_s": 0.01, "role": "any", "weight_version": 3,
         "breaker": {"state": "closed"}},
        {"name": "fleet.r1", "state": "backoff", "restarts": 0,
         "deaths": 2, "heartbeats": 7, "load": 0, "role": "decode",
         "weight_version": 2, "breaker": {"state": "open"}}],
    "affinity": {"lookups": 10, "hits": 4, "hit_rate": 0.4,
                 "per_replica": {"fleet.r0": {"hits": 4,
                                              "prefix_hit_rate": 0.25}}},
}


@pytest.mark.parametrize("fleet", [None, FLEET_SNAP],
                         ids=["serving", "serving_fleet"])
def test_prometheus_text_identical_to_reference(monkeypatch, fleet):
    from paddle_tpu.distributed import gang as jgang
    from paddle_tpu.distributed.ps import heter as jheter

    # the reference's live-cache and gang gauges over none alive, as the
    # port reports them
    monkeypatch.setattr(jheter, "_CACHES", set())
    monkeypatch.setattr(jgang, "_SUPERVISORS", set())
    jmonitor.reset()
    tmonitor.reset()
    jm = _feed(jmetrics, jmonitor, jobs, monkeypatch)
    tm = _feed(tmetrics, tmonitor, tobs, monkeypatch)
    want = jobs.prometheus_text(serving=jm, queue_depth=5, fleet=fleet)
    got = tobs.prometheus_text(serving=tm, queue_depth=5, fleet=fleet)
    assert got.splitlines() == want.splitlines()
    for ln in filter(None, got.splitlines()):
        assert _PROM_LINE.match(ln), ln
    assert "paddle_serving_tokens_out_total 96" in got
    assert 'paddle_serving_mesh_role{mesh="single",role="decode"} 2' in got
    # the JSON view: same sections and values where neither clock nor
    # process enters
    snap, ref = tobs.snapshot(), jobs.snapshot()
    for key in ("monitor", "timeline", "goodput", "ps", "rec", "fleet",
                "gang", "mesh", "kvstore", "lowp"):
        assert snap[key] == ref[key], key
    tmonitor.reset()
    jmonitor.reset()


# ---------------------------------------------------------------------------
# checkpoint phases and goodput
# ---------------------------------------------------------------------------


def _mlp_engines():
    from paddle_tpu_torch import nn as tnn

    rng = np.random.RandomState(0)
    jl = paddle.nn.Linear(6, 3)
    jeng = JEngine(jl, paddle.optimizer.Adam(learning_rate=0.05,
                                             parameters=jl.parameters()),
                   lambda o, y: ((o - y) ** 2).mean())
    tl = tnn.Linear(6, 3)
    teng = TEngine(tl, topt.Adam(learning_rate=0.05,
                                 parameters=tl.parameters()),
                   lambda o, y: ((o - y) ** 2).mean(), device="cpu")
    x, y = rng.randn(8, 6).astype(np.float32), \
        rng.randn(8, 3).astype(np.float32)
    return jeng, teng, (x,), (y,)


def _ckpt_ops(ckpt, eng, d):
    sync = ckpt.CheckpointManager(str(d / "sync"))
    sync.save_engine(1, eng)
    sync.restore_with(lambda p: ckpt.load_train_state(p, eng))
    asy = ckpt.AsyncCheckpointManager(str(d / "async"))
    asy.save_engine(2, eng)
    asy.close()
    asy.restore_with(lambda p: ckpt.load_train_state(p, eng))


def test_checkpoint_phases_match_reference(tmp_path):
    jeng, teng, x, y = _mlp_engines()
    for _ in range(2):
        jeng.train_batch(x, y)
        teng.train_batch(x, y)
    jobs.timeline.reset()
    tobs.timeline.reset()
    _ckpt_ops(jckpt, jeng, tmp_path / "j")
    _ckpt_ops(tckpt, teng, tmp_path / "t")
    calls = _phase_calls(tobs)
    assert calls == _phase_calls(jobs)
    assert calls == {"checkpoint-write": 1, "checkpoint-restore": 2,
                     "checkpoint-snapshot": 1, "checkpoint-write-async": 1}
    teng.train_batch(x, y)
    gp = tobs.goodput()
    assert gp["categories_s"]["checkpoint"] > 0
    assert gp["categories_s"]["restore"] > 0
    assert gp["categories_s"]["productive"] > 0
    assert gp["overlapped_s"] > 0
    assert gp["accounted_s"] == pytest.approx(
        sum(gp["categories_s"].values()))


# ---------------------------------------------------------------------------
# the HTTP front's /metrics
# ---------------------------------------------------------------------------


def _get(port, query="", accept=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/metrics{query}",
        headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def _families(text):
    return sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE ")})


def _negotiate(srv, front):
    srv.submit(np.ones((3,), np.float32)).result(timeout=60)
    httpd = front(srv, port=0)
    port = httpd.server_address[1]
    try:
        bare = _get(port)
        text = _get(port, accept="text/plain")
        query = _get(port, query="?format=prometheus")
        direct = srv.metrics_prometheus()
    finally:
        httpd.shutdown()
        httpd.server_close()
    return bare, text, query, direct


def test_http_metrics_content_negotiation_matches_reference():
    jsrv = jserving.Server(fn=lambda x: jnp.tanh(x), mode="batch",
                           max_batch=4).start()
    tsrv = tserving.Server(fn=lambda x: torch.tanh(torch.from_numpy(x)),
                           mode="batch", max_batch=4).start()
    try:
        out = {}
        for key, srv, front in (("j", jsrv, jserving.http_front),
                                ("t", tsrv, tserving.http_front)):
            try:
                out[key] = _negotiate(srv, front)
            except OSError as e:
                pytest.skip(f"cannot bind loopback: {e}")
    finally:
        jsrv.shutdown(drain=True)
        tsrv.shutdown(drain=True)
    (jb, jt, jq, _), (tb, tt, tq, tdirect) = out["j"], out["t"]
    assert tb[0] == jb[0] and "application/json" in tb[0]
    assert "counters" in json.loads(tb[1])
    for (tct, ttxt), (jct, jtxt) in ((tt, jt), (tq, jq)):
        assert tct == jct and "text/plain" in tct
        for ln in filter(None, ttxt.splitlines()):
            assert _PROM_LINE.match(ln), ln
        assert "paddle_serving_queue_depth" in ttxt
        assert "paddle_serving_batches_total" in ttxt
        assert _families(ttxt) == _families(tdirect)
    # the serving families are the same; the generic monitor families
    # list each package's own process-wide stats
    assert [f for f in _families(tt[1]) if f.startswith("paddle_serving_")] \
        == [f for f in _families(jt[1]) if f.startswith("paddle_serving_")]
