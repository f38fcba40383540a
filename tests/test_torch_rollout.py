"""Port parity: paddle_tpu_torch's weight rollout (`WeightVersion`,
`WeightRegistry`, `RolloutController`, `golden_digests`) on the CPU
against paddle_tpu's, on the same numpy weights (tiny GPT: vocab 97,
hidden 64, 2 layers).

- Digests: `artifact_digest`, a version's per-leaf manifest and its
  whole-artifact digest are identical strings in both packages, f32 and
  int8-frozen; `golden_digests` (the eager full re-forward greedy
  chain) gives identical digests, f32 and int8 (the int8 head through
  `dequant_matmul`).
- Registry: a committed port checkpoint dir is ingested with its saved
  manifest (float and int8 templates); version ids only grow; a torn
  dir, a tampered manifest and a ``serving.rollout_load`` fault are
  refused at the registry; `watch` picks up committed dirs only.
- Rollout runs on a 2-replica port fleet: a rolling upgrade commits
  under traffic and then serves the reference's golden digest; a canary
  fault (``serving.canary``) with a faulted first rollback
  (``serving.rollback``) rolls back and serves the pre-rollout tokens
  bit for bit; a version whose golden digests were made from other
  values is refused by the gate; a replay stays on its weight version
  and a retired pin fails with `VersionRetiredError` (503, retriable);
  a commit fences the spill tier's records of the retired version and
  the resume re-prefills to a cold server's tokens.
- `SLOWindow`'s freshness gate reads the same p99 / None sequence.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.quantization import quantize_state_int8 as jquantize
from paddle_tpu.serving import ServingMetrics as JMetrics
from paddle_tpu.serving import autoscale as jautoscale
from paddle_tpu.serving import rollout as jrollout

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.framework import faults, monitor
from paddle_tpu_torch.quantization import quantize_state_int8
from paddle_tpu_torch.serving import rollout
from torch_parity import VOCAB, build_pair, prompt

ENGINE = dict(max_slots=2, block_size=8)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    yield
    faults.reset()


def _noisy(vals, seed, scale=0.05):
    """numpy values + seeded noise: the same shapes, other decodes."""
    rng = np.random.RandomState(seed)
    return {k: (v + rng.normal(0.0, scale, v.shape)).astype(v.dtype)
            for k, v in vals.items()}


def _torch(vals):
    return {k: torch.as_tensor(v) for k, v in vals.items()}


def _jax(vals):
    return {k: jnp.asarray(v) for k, v in vals.items()}


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg", ["f32", "int8"])
def test_version_digests_match_reference(pair, leg):
    """Exact: identical manifests and artifact digests."""
    _, _, vals = pair
    v = _noisy(vals, 1)
    tv, jv = _torch(v), _jax(v)
    if leg == "int8":
        tv, jv = quantize_state_int8(tv), jquantize(jv)
    t = rollout.WeightVersion(3, tv)
    j = jrollout.WeightVersion(3, jv)
    assert t.manifest == j.manifest
    assert t.digest == j.digest
    assert rollout.artifact_digest(t.manifest) == \
        jrollout.artifact_digest(j.manifest)
    assert t.quant == j.quant
    if leg == "int8":
        tq = rollout.WeightVersion.quantized_from(
            rollout.WeightVersion(1, _torch(v)), 2)
        jq = jrollout.WeightVersion.quantized_from(
            jrollout.WeightVersion(1, _jax(v)), 2)
        assert tq.digest == jq.digest and tq.quant == jq.quant


@pytest.mark.parametrize("leg", ["f32", "int8"])
def test_golden_digests_match_reference(pair, leg):
    """Exact: the same greedy chains, hashed. Prompts as the
    controller synthesizes them (seeded)."""
    jm, tm, vals = pair
    v = _noisy(vals, 2)
    tv, jv = _torch(v), _jax(v)
    if leg == "int8":
        tv, jv = quantize_state_int8(tv), jquantize(jv)
    rng = np.random.RandomState(0xC0DE)
    prompts = [tuple(int(t) for t in rng.randint(1, VOCAB, size=5))
               for _ in range(4)]
    want = jrollout.golden_digests(jm, jv, prompts, max_new=6)
    got = rollout.golden_digests(tm, tv, prompts, max_new=6)
    assert got == want
    toks, rows = rollout.golden_logits(tm, tv, prompts[0], max_new=6)
    assert len(rows) == 6 and rows[0].shape == (VOCAB,)
    assert rollout._digest_ids(toks) == got["p0"]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_ingests_committed_port_checkpoints(tmp_path, pair):
    _, tm, vals = pair
    reg = tserving.WeightRegistry(tm)
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=10)
    v2 = _torch(_noisy(vals, 3))
    mgr.save(2, v2)
    wv = reg.load_dir(str(tmp_path / "ckpt-2"), version=2)
    assert wv.version == 2 and reg.latest() == 2
    assert wv.manifest == rollout.WeightVersion(9, v2).manifest
    for k in v2:
        assert torch.equal(wv.values[k], v2[k])
    with pytest.raises(ValueError, match="monotonic"):
        reg.load_dir(str(tmp_path / "ckpt-2"), version=2)
    with pytest.raises(ValueError, match="monotonic"):
        reg.add(rollout.WeightVersion(1, v2))
    assert reg.load_dir(str(tmp_path / "ckpt-2")).version == 3
    # an int8 artifact loads against an int8 template
    q = quantize_state_int8(_torch(_noisy(vals, 4)))
    ckpt.save_state(str(tmp_path / "int8"), q)
    reg8 = tserving.WeightRegistry(
        tm, template=quantize_state_int8(_torch(vals)))
    wq = reg8.load_dir(str(tmp_path / "int8"))
    assert wq.version == 1 and wq.quant is not None
    assert wq.values["gpt.embeddings.word_embeddings.weight"].dtype == \
        torch.int8


def test_registry_refuses_torn_and_tampered_dirs(tmp_path, pair):
    _, tm, vals = pair
    reg = tserving.WeightRegistry(tm)
    before = reg.snapshot()
    fails0 = monitor.stat_get("fleet.rollout_load_failures")
    torn = tmp_path / "ckpt-3"
    torn.mkdir()
    (torn / "d").mkdir()
    with pytest.raises(ValueError, match="not a committed checkpoint"):
        reg.load_dir(str(torn))
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=10)
    mgr.save(4, _torch(_noisy(vals, 5)))
    man_path = tmp_path / "ckpt-4" / ckpt.MANIFEST_NAME
    man = json.loads(man_path.read_text())
    man[sorted(man)[0]]["sha256"] = "0" * 64
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="checksum"):
        reg.load_dir(str(tmp_path / "ckpt-4"))
    mgr.save(5, _torch(_noisy(vals, 6)))
    with faults.ChaosSchedule("serving.rollout_load@1:raise") as ch:
        with pytest.raises(faults.FaultError):
            reg.load_dir(str(tmp_path / "ckpt-5"))
        ch.verify()
    assert reg.snapshot() == before
    assert monitor.stat_get("fleet.rollout_load_failures") >= fails0 + 2
    assert reg.load_dir(str(tmp_path / "ckpt-5"), version=5).version == 5


def test_registry_watch_picks_up_committed_dirs_only(tmp_path, pair):
    _, tm, vals = pair
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=10)
    mgr.save(1, _torch(_noisy(vals, 7)))
    (tmp_path / "ckpt-2.tmp").mkdir()          # an in-flight write
    reg = tserving.WeightRegistry(tm)
    seen = []
    reg.watch(str(tmp_path), poll_s=0.01, on_version=seen.append)
    try:
        assert _wait(lambda: reg.latest() == 1)
        mgr.save(3, _torch(_noisy(vals, 8)))
        assert _wait(lambda: reg.latest() == 3)
    finally:
        reg.stop_watch()
    assert [w.version for w in seen] == [1, 3]
    assert not reg.is_live(2)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_slo_window_freshness_matches_reference():
    seqs = {}
    for name, mod, metrics in (("port", tserving, tserving.ServingMetrics()),
                               ("ref", jautoscale, JMetrics())):
        now = [100.0]
        w = mod.SLOWindow(metrics, freshness_s=2.0, window=4,
                          clock=lambda: now[0])
        seq = [w.p99_s()]
        for dt, n, lat in ((0.0, 3, 0.2), (1.0, 0, 0.0), (1.5, 0, 0.0),
                           (0.5, 2, 0.9), (0.1, 0, 0.0), (2.5, 0, 0.0)):
            now[0] += dt
            for _ in range(n):
                metrics.inc("fleet_completed")
                metrics.observe_latency("e2e", lat)
            seq.append(w.p99_s())
        seqs[name] = seq
    assert seqs["port"] == seqs["ref"]
    assert seqs["port"][0] is None and seqs["port"][-1] is None


# ---------------------------------------------------------------------------
# rollout runs on a live port fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet(pair):
    _, tm, _ = pair
    router = tserving.Router(tm, replicas=2, engine_kw=dict(ENGINE),
                             hedge=False, retry_budget=3,
                             liveness_timeout_s=30.0, backoff_base_s=0.02,
                             name="ro", device="cpu").start()
    yield router
    router.shutdown(drain=True, timeout=30.0)


@pytest.fixture(scope="module")
def controller(fleet, pair):
    _, tm, _ = pair
    reg = tserving.WeightRegistry(tm)
    ro = tserving.RolloutController(fleet, reg, canary_secs=0.05,
                                    wave_size=1, poll_s=0.005,
                                    replica_timeout_s=120.0,
                                    slo_p99_ms=60000.0)
    return reg, ro


def _versions(router):
    return {r.engine.weight_version for r in router.replica_set.replicas
            if r.state == "healthy"}


def test_rolling_upgrade_commits_under_traffic(fleet, pair, controller):
    jm, _, vals = pair
    reg, ro = controller
    v1 = _noisy(vals, 7)
    wv1 = reg.add(tserving.WeightVersion(1, _torch(v1)))
    stop, errs = threading.Event(), []

    def traffic():
        i = 0
        while not stop.is_set():
            try:
                fleet.generate(prompt(100 + i % 5, 6), max_new_tokens=4,
                               timeout=60.0)
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)
            i += 1

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        assert ro.roll_to(1) is True, ro.error
    finally:
        stop.set()
        t.join(60.0)
    assert not t.is_alive() and not errs, errs[:3]
    assert ro.state == "committed" and _versions(fleet) == {1}
    assert reg.current == 1 and reg.previous is None and 0 in reg.retired
    assert monitor.stat_get("fleet.weight_version") == 1
    # the committed fleet serves v1's golden chain, whose digests equal
    # the reference's chain over the same values
    want = jrollout.golden_digests(jm, _jax(v1), ro._prompts(),
                                   max_new=ro.golden_max_new)
    assert wv1.golden == want
    out = fleet.generate(list(ro._prompts()[0]),
                         max_new_tokens=ro.golden_max_new, timeout=60.0)
    assert rollout._digest_ids(out) == want["p0"]
    info = fleet.version_info()
    assert info["current"] == 1 and info["state"] == "committed"
    assert set(info["replicas"].values()) == {1}


def test_canary_fault_rolls_back_bit_for_bit(fleet, pair, controller):
    _, _, vals = pair
    reg, ro = controller
    rollbacks0 = monitor.stat_get("fleet.rollbacks")
    reg.add(tserving.WeightVersion(2, _torch(_noisy(vals, 8))))
    probe = prompt(42, 6)
    pre = np.asarray(fleet.generate(probe, max_new_tokens=6, timeout=60.0))
    with faults.ChaosSchedule("serving.canary@1:raise",
                              "serving.rollback@1:raise") as ch:
        assert ro.roll_to(2) is False
        ch.verify()
    assert ro.state == "rolled_back" and "FaultError" in ro.error
    assert fleet.metrics.get("rollback_retries") >= 1
    assert monitor.stat_get("fleet.rollbacks") == rollbacks0 + 1
    assert _versions(fleet) == {1} and reg.current == 1
    assert 2 in reg.retired
    np.testing.assert_array_equal(
        np.asarray(fleet.generate(probe, max_new_tokens=6, timeout=60.0)),
        pre)
    with pytest.raises(tserving.RolloutError, match="no rollout"):
        ro.rollback()


def test_golden_gate_refuses_a_mislabelled_version(fleet, pair, controller):
    """A version whose golden digests were made from other values: the
    canary's served decode disagrees, the gate refuses, the rollback
    serves the old version's tokens bit for bit."""
    _, tm, vals = pair
    reg, ro = controller
    probe = prompt(43, 6)
    pre = np.asarray(fleet.generate(probe, max_new_tokens=6, timeout=60.0))
    wrong = rollout.golden_digests(tm, _torch(_noisy(vals, 99)),
                                   ro._prompts(), max_new=ro.golden_max_new)
    reg.add(tserving.WeightVersion(3, _torch(_noisy(vals, 9)),
                                   golden=wrong))
    failures0 = fleet.metrics.get("canary_failures")
    assert ro.roll_to(3) is False
    assert "golden-prompt digest mismatch" in ro.error
    assert fleet.metrics.get("canary_failures") == failures0 + 1
    assert _versions(fleet) == {1} and 3 in reg.retired
    np.testing.assert_array_equal(
        np.asarray(fleet.generate(probe, max_new_tokens=6, timeout=60.0)),
        pre)


def test_replay_is_version_pinned_and_a_retired_pin_fails(fleet,
                                                          controller):
    rs = fleet.replica_set
    assert _versions(fleet) == {1}
    pinned0 = fleet.metrics.get("replays_pinned")
    futs = [fleet.submit(prompt(200 + i, 6), max_new_tokens=12,
                         timeout=60.0) for i in range(6)]
    victim = next(r for r in rs.replicas if r.load > 0)
    fleet.kill(victim.name)
    assert all(np.asarray(f.result(60.0)).size == 18 for f in futs)
    assert fleet.metrics.get("replays_pinned") > pinned0
    assert _wait(lambda: victim.state == "healthy"
                 and victim.engine.weight_version == 1, 60)
    retired0 = fleet.metrics.get("version_retired_failures")
    fut = fleet.submit(prompt(300, 6), max_new_tokens=40, timeout=60.0)
    with fleet._lock:
        flight = fleet._flights[fut.id]
        flight.pin = 0                   # v0 was retired at commit
        victim = next(rep for rep, _ in flight.attempts.values())
    assert 0 not in rs.versions_live()
    fleet.kill(victim.name)
    with pytest.raises(tserving.VersionRetiredError) as ei:
        fut.result(60.0)
    assert ei.value.status == 503 and ei.value.retriable
    assert fleet.metrics.get("version_retired_failures") == retired0 + 1
    assert _wait(lambda: len(rs.healthy()) == 2, 60)


def test_version_endpoint_over_http(fleet, controller):
    srv = tserving.Server.from_router(fleet)
    snap = json.loads(srv.metrics_json())
    assert all(rep["weight_version"] == 1
               for rep in snap["fleet"]["replicas"])
    assert snap["fleet"]["rollout"]["registry"]["current"] == 1
    httpd = tserving.http_front(srv, port=0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/version", timeout=30) as r:
            info = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert info["current"] == 1 and info["versions_live"] == [1]
    assert set(info["replicas"]) == {"ro.r0", "ro.r1"}


def test_commit_fences_spilled_kv_and_resume_reprefills(tmp_path, pair):
    _, tm, vals = pair
    tserving.reset_spill_stores()
    router = tserving.Router(
        tm, replicas=2, engine_kw=dict(ENGINE, prefill_chunk=8,
                                       spill_dir=str(tmp_path)),
        hedge=False, retry_budget=3, liveness_timeout_s=30.0,
        backoff_base_s=0.02, name="rofence", device="cpu").start()
    try:
        reg = tserving.WeightRegistry(tm)
        tserving.RolloutController(router, reg, canary_secs=0.05,
                                   wave_size=1, poll_s=0.005,
                                   slo_p99_ms=60000.0)
        p1 = prompt(41, 16)
        out1 = np.asarray(router.submit(p1, max_new_tokens=3,
                                        timeout=120.0).result(120.0))
        store = None
        for r in router.replica_set.replicas:
            r.engine.spill_cache()
            store = store or r.engine.spill_store
        assert len(store) > 0
        reg.add(tserving.WeightVersion(1, _torch(_noisy(vals, 17))))
        reg.begin(1)
        reg.commit(1)
        with pytest.raises(tserving.SpillFencedError) as ei:
            store.get(next(iter(store._index)))
        assert ei.value.status == 503 and ei.value.retriable
        for r in router.replica_set.replicas:
            r.engine.spill_cache()
        fenced0 = router.metrics.get("kv_restore_fenced")
        p2 = np.concatenate([out1, prompt(43, 5)])
        out2 = np.asarray(router.submit(p2, max_new_tokens=3,
                                        timeout=120.0).result(120.0))
        assert router.metrics.get("kv_restore_fenced") > fenced0
        with tserving.Server(tm, max_slots=2, block_size=8,
                             prefix_cache=False, device="cpu") as ref:
            np.testing.assert_array_equal(
                out2, np.asarray(ref.generate(p2, max_new_tokens=3,
                                              timeout=120.0)))
    finally:
        router.shutdown(drain=True, timeout=30.0)
        tserving.reset_spill_stores()
