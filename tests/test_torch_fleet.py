"""Port parity: paddle_tpu_torch's serving fleet (`ReplicaSet` / `Router`
and the `Autoscaler`) on the CPU against paddle_tpu's, on the same numpy
weights (tiny GPT: vocab 97, hidden 64, 2 layers) and the same seeded
prompts.

- Router tokens: greedy tokens of a 2-replica fleet equal the
  reference fleet's exactly (tolerance 0: both run f32 on the CPU, and
  these prompts have no near-tie), f32 and int8.
- Failover: a crashed (heartbeat raise), a killed and a hung (heartbeat
  delay past the liveness timeout) replica's in-flight request replays
  to the uninterrupted run's tokens exactly, delivered once, in both
  packages. The abandoned engine is collectable once its thread exits.
- Breaker: the same `CircuitBreaker` transitions under a fake clock.
- Brownout: shedding by priority and clamping, forced and through the
  hysteresis tick (its load signals set, not raced).
- Faults: a route fault (raise and drop) is retried, and a scripted
  `ChaosSchedule` sweep resolves every request exactly once.
- Membership: a faulted scale-up rolls back, a scale-up under load
  serves, a drain with chaos at its sites loses nothing, a replica
  killed mid-drain replays and is dropped.
- Serving modes: disaggregated prefill/decode (every decode leg adopts
  migrated KV) and prefix affinity (a second turn lands on the first
  turn's replica; an affinity fault degrades one decision).
- Autoscaler: the same decision sequence as the reference's under a
  fake clock and scripted fleet signals; one real tick grows a real
  fleet and one shrinks it.
- The kernels' launch counters stay exact under concurrent callers.

Every wait is bounded (``result(timeout=...)``, joins with a timeout).
"""

from __future__ import annotations

import gc
import threading
import time
import weakref

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.framework import faults as jfaults

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.framework import faults, monitor
from paddle_tpu_torch.ops import _launch, quant_ops
from torch_parity import build_pair, prompt

ENGINE = dict(max_slots=2, block_size=8)
FAULTS = {"port": faults, "reference": jfaults}
PKGS = ("port", "reference")


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _router(pkg, pair, **kw):
    """A started 2-replica Router of `pkg` on the tiny GPT (the port's
    on the CPU)."""
    jm, tm, _ = pair
    kw.setdefault("engine_kw", dict(ENGINE))
    kw.setdefault("hedge", False)
    kw.setdefault("liveness_timeout_s", 30.0)
    kw.setdefault("backoff_base_s", 0.02)
    if pkg == "port":
        return tserving.Router(tm, device="cpu", **kw).start()
    return jserving.Router(jm, **kw).start()


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture(scope="module")
def fleets(pair):
    """One shared 2-replica fleet per package (retry budget 3, breakers
    out of the way)."""
    out = {pkg: _router(pkg, pair, retry_budget=3, breaker_threshold=10,
                        name="tf") for pkg in PKGS}
    yield out
    for r in out.values():
        r.shutdown(drain=True, timeout=30.0)


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg", ["f32", "int8"])
def test_router_tokens_match_reference(pair, leg):
    """Tolerance 0: equal greedy tokens."""
    kw = dict(engine_kw=dict(ENGINE, quantize=leg == "int8"), name="tk")
    prompts = [prompt(60 + i, 4 + i) for i in range(4)]
    outs = {}
    for pkg in PKGS:
        r = _router(pkg, pair, **kw)
        try:
            futs = [r.submit(p, max_new_tokens=6) for p in prompts]
            outs[pkg] = [np.asarray(f.result(120)) for f in futs]
            assert r.metrics.get("fleet_completed") == len(prompts)
            loads = [rep.engine.metrics.get("steps")
                     for rep in r.replica_set.replicas]
            assert all(n > 0 for n in loads)
        finally:
            r.shutdown(drain=True, timeout=30.0)
    for a, b in zip(outs["port"], outs["reference"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_failover_replay_matches_uninterrupted_run(pair, pkg):
    """A kill mid-flight, then a crash (a raise at the heartbeat kills
    the engine thread, the watchdog sees it): each replays to the
    uninterrupted tokens (tolerance 0), exactly once, and the replica
    is rebuilt."""
    f = FAULTS[pkg]
    r = _router(pkg, pair, name="kf")
    try:
        p = prompt(70, 6)
        ref = np.asarray(r.submit(p, max_new_tokens=8).result(120))
        resolved = []
        with f.inject("serving.replica_step[kf.r0]@*:delay:0.05"):
            fut = r.submit(p, max_new_tokens=8)
            fut.add_done_callback(lambda q: resolved.append(q.id))
            time.sleep(0.12)
            r.kill("kf.r0")
            out = np.asarray(fut.result(120))
        np.testing.assert_array_equal(out, ref)
        assert len(resolved) == 1
        assert r.metrics.get("replays") >= 1
        assert _wait(lambda: all(x["state"] == "healthy"
                                 for x in r.snapshot()["replicas"]), 60)
        deaths = r.metrics.get("replica_deaths")
        with f.ChaosSchedule("serving.replica_heartbeat[kf.r0]@3:raise",
                             "serving.replica_step[kf.r0]@*:delay:0.02"):
            futs = [r.submit(p, max_new_tokens=8) for _ in range(2)]
            outs = [np.asarray(x.result(120)) for x in futs]
        for o in outs:
            np.testing.assert_array_equal(o, ref)
        assert r.metrics.get("replica_deaths") > deaths
        assert _wait(lambda: r.metrics.get("replica_restarts") >= 2, 60)
        # a replay whose own path faults surfaces as a typed error
        with f.inject("serving.replica_step[kf.r0]@*:delay:0.05",
                      "serving.replay@1:raise"):
            fut = r.submit(p, max_new_tokens=8)
            time.sleep(0.12)
            r.kill("kf.r0")
            err = fut.exception(120)
        assert isinstance(err, (tserving.ServingError,
                                jserving.ServingError))
    finally:
        r.shutdown(drain=True, timeout=30.0)


def test_hung_replica_is_replayed_and_its_engine_freed(pair):
    """A hang (a heartbeat delay past the liveness timeout): the
    watchdog declares the replica dead, its request replays to the
    uninterrupted tokens, and the abandoned engine — pools and weight
    copy — is collectable once its thread wakes and exits."""
    r = _router("port", pair, liveness_timeout_s=1.0, name="wd")
    try:
        p = prompt(77, 5)
        ref = np.asarray(r.submit(p, max_new_tokens=5).result(120))
        old = weakref.ref(r.replica_set.replicas[0].engine)
        thread = r.replica_set.replicas[0].engine._thread
        with faults.inject("serving.replica_heartbeat[wd.r0]@2-:delay:2.5"):
            futs = [r.submit(p, max_new_tokens=5) for _ in range(3)]
            for x in futs:
                np.testing.assert_array_equal(np.asarray(x.result(120)),
                                              ref)
        assert r.metrics.get("replica_deaths") >= 1
        assert _wait(lambda: r.replica_set.replicas[0].state == "healthy"
                     and r.replica_set.replicas[0].engine is not old(), 60)
        thread.join(30.0)
        assert not thread.is_alive()
        del thread
        gc.collect()
        assert old() is None
    finally:
        r.shutdown(drain=True, timeout=30.0)


# ---------------------------------------------------------------------------
# breaker, brownout, faults
# ---------------------------------------------------------------------------


def _breaker_trace(cls):
    now = [0.0]
    br = cls(threshold=2, cooloff_s=1.0, clock=lambda: now[0])
    out = []
    script = ["allow", "fail", "fail", "allow", ("t", 1.5), "allow",
              "allow", "fail", ("t", 3.0), "probe", "allow", "ok",
              "fail", "ok", "fail", "fail", ("t", 3.5), "probe",
              ("t", 4.0), "probe", "allow", "allow", "ok", "allow"]
    for step in script:
        if isinstance(step, tuple):
            now[0] = step[1]
            continue
        got = {"allow": br.allow, "probe": br.probe_ready,
               "fail": br.record_failure, "ok": br.record_success}[step]()
        out.append((step, got, br.snapshot()))
    return out


def test_circuit_breaker_transitions_match_reference():
    """Exact: the same (result, state, failures) after every call."""
    assert _breaker_trace(tserving.CircuitBreaker) == \
        _breaker_trace(jserving.CircuitBreaker)
    with pytest.raises(ValueError):
        tserving.CircuitBreaker(threshold=0)


def test_retriable_classifier_matches_reference():
    names = ["CapacityExhaustedError", "QueueFullError", "ServerClosedError",
             "ReplicaDiedError", "RequestCancelled", "DeadlineExceededError",
             "VersionRetiredError", "BrownoutShedError", "TenantBudgetError"]
    for n in names:
        t, j = getattr(tserving, n)("x"), getattr(jserving, n)("x")
        assert tserving.retriable(t) == jserving.retriable(j), n
        assert (t.status, t.retriable, t.retry_after_s) == \
            (j.status, j.retriable, j.retry_after_s), n
    assert tserving.retriable(faults.FaultError("x"))
    assert not tserving.retriable(ValueError("x"))
    e = tserving.RetriesExhaustedError("x", last_error=KeyError("k"))
    assert isinstance(e.last_error, KeyError) and e.status == 503


@pytest.mark.parametrize("pkg", PKGS)
def test_brownout_sheds_by_priority_and_clamps(fleets, pkg):
    r = fleets[pkg]
    err = {"port": tserving.BrownoutShedError,
           "reference": jserving.BrownoutShedError}[pkg]
    p = prompt(74, 5)
    r.set_brownout(True)
    try:
        with pytest.raises(err) as ei:
            r.submit(p, max_new_tokens=12, priority=0)
        assert ei.value.status == 429 and ei.value.retriable
        out = np.asarray(r.submit(p, max_new_tokens=12,
                                  priority=2).result(120))
        assert out.size == p.size + r._brownout_max_new
    finally:
        r.set_brownout(None)
    out = np.asarray(r.submit(p, max_new_tokens=12).result(120))
    assert out.size == p.size + 12


def test_brownout_hysteresis_matches_reference(fleets):
    """The automatic tick: the same enter / exit sequence for the same
    load fractions (the fleet's load signals are set, not raced)."""
    loads = [10, 96, 70, 51, 50, 20, 95, 0]      # of a capacity of 100
    seqs = {}
    for pkg, r in fleets.items():
        rs = r.replica_set
        seq = []
        try:
            rs.capacity = lambda: 100
            for n in loads:
                rs.in_flight = lambda n=n: n
                r._brownout_tick()
                seq.append(r.brownout_active)
            rs.capacity = lambda: 0       # nothing healthy: brownout
            r._brownout_tick()
            seq.append(r.brownout_active)
        finally:
            del rs.capacity, rs.in_flight
            r._brownout = False
        seqs[pkg] = seq
    assert seqs["port"] == seqs["reference"]
    assert seqs["port"] == [False, True, True, True, False, False, True,
                            False, True]


@pytest.mark.parametrize("pkg", PKGS)
def test_route_fault_is_retried(fleets, pair, pkg):
    r, f = fleets[pkg], FAULTS[pkg]
    p = prompt(76, 5)
    ref = np.asarray(r.submit(p, max_new_tokens=4).result(120))
    before = r.metrics.get("retries")
    with f.ChaosSchedule("serving.route@1:raise") as ch:
        out = np.asarray(r.submit(p, max_new_tokens=4).result(120))
        ch.verify()
    np.testing.assert_array_equal(out, ref)
    with f.ChaosSchedule("serving.route@1:drop") as ch:
        out = np.asarray(r.submit(p, max_new_tokens=4).result(120))
        ch.verify()
    np.testing.assert_array_equal(out, ref)
    assert r.metrics.get("retries") >= before + 2
    # a persistent fault burns the retry budget into a typed error
    with f.inject("serving.route@*:raise"):
        err = r.submit(p, max_new_tokens=4).exception(120)
    assert type(err).__name__ == "RetriesExhaustedError"
    assert err.retriable


@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_sweep_zero_lost_zero_duplicated(fleets, pkg):
    """Every request resolves exactly once — the uninterrupted tokens
    or a typed ServingError — and the schedule fired in full."""
    r, f = fleets[pkg], FAULTS[pkg]
    err_t = {"port": tserving.ServingError,
             "reference": jserving.ServingError}[pkg]
    prompts = [prompt(80 + i, 4 + i % 3) for i in range(6)]
    refs = [np.asarray(r.submit(p, max_new_tokens=5).result(120))
            for p in prompts]
    resolutions, lock = [], threading.Lock()

    def on_done(req):
        with lock:
            resolutions.append(req.id)

    sub0 = r.metrics.get("fleet_submitted")
    done0 = r.metrics.get("fleet_completed") + r.metrics.get("fleet_failed")
    with f.ChaosSchedule("serving.replica_step[tf.r0]@2:raise",
                         "serving.replica_step[tf.r1]@3:raise",
                         "serving.route@4:raise") as sched:
        futs = []
        for p in prompts:
            fut = r.submit(p, max_new_tokens=5)
            fut.add_done_callback(on_done)
            futs.append(fut)
        ok = 0
        for ref, fut in zip(refs, futs):
            try:
                np.testing.assert_array_equal(
                    np.asarray(fut.result(120)), ref)
                ok += 1
            except err_t:
                pass
        fired = sched.verify()
    assert fired["serving.replica_step"] == 2
    assert fired["serving.route"] == 1
    assert ok >= 1
    assert sorted(resolutions) == sorted(x.id for x in futs)
    m = r.metrics
    assert m.get("fleet_submitted") - sub0 == \
        m.get("fleet_completed") + m.get("fleet_failed") - done0


# ---------------------------------------------------------------------------
# elastic membership
# ---------------------------------------------------------------------------


def test_membership_scale_up_and_drain_lose_nothing(pair):
    """A faulted scale-up rolls membership back; a scale-up under load
    serves the same tokens; a drain with chaos at its sites, and a
    replica killed mid-drain, lose and duplicate nothing."""
    r = _router("port", pair, retry_budget=3, name="ef")
    rs = r.replica_set
    try:
        before = [x.name for x in rs.replicas]
        with faults.ChaosSchedule("serving.scale_up@1:raise") as ch:
            with pytest.raises(faults.FaultError):
                rs.add_replica()
            ch.verify()
        assert [x.name for x in rs.replicas] == before
        prompts = [prompt(30 + i, 5 + i % 3) for i in range(6)]
        refs = [np.asarray(r.submit(p, max_new_tokens=5).result(120))
                for p in prompts]
        futs = [r.submit(p, max_new_tokens=5) for p in prompts]
        ups = monitor.stat_get("fleet.scale_events_up")
        newcomer = rs.add_replica()
        assert monitor.stat_get("fleet.scale_events_up") == ups + 1
        for fut, ref in zip(futs, refs):
            np.testing.assert_array_equal(np.asarray(fut.result(120)), ref)
        assert newcomer.state == "healthy" and rs.member_replicas() == 3
        assert newcomer.name == "ef.r3"      # names never recycle
        # drain the newcomer under load, chaos at both drain sites
        futs = [r.submit(p, max_new_tokens=5) for p in prompts]
        with faults.ChaosSchedule("serving.scale_down@1:delay:0.005",
                                  "serving.drain@1:raise") as ch:
            assert r.remove_replica(newcomer.name).state == "draining"
            for fut, ref in zip(futs, refs):
                np.testing.assert_array_equal(np.asarray(fut.result(120)),
                                              ref)
            assert _wait(lambda: newcomer.name not in
                         [x.name for x in rs.replicas], 30)
            ch.verify()
        assert r.metrics.get("drain_errors") >= 1
        assert newcomer.state == "stopped"
        # kill a draining replica mid-flight: replayed, then dropped
        victim = rs.replicas[0]
        restarts = r.metrics.get("replica_restarts")
        resolved = []
        with faults.inject(
                "serving.replica_step[ef.r0]@*:delay:0.02"):
            futs = [r.submit(p, max_new_tokens=5) for p in prompts]
            for fut in futs:
                fut.add_done_callback(lambda q: resolved.append(q.id))
            r.remove_replica(victim.name, drain=True)
            rs.kill(victim.name, "chaos: died mid-drain")
            for fut, ref in zip(futs, refs):
                np.testing.assert_array_equal(np.asarray(fut.result(120)),
                                              ref)
        assert sorted(resolved) == sorted(x.id for x in futs)
        assert _wait(lambda: victim.name not in
                     [x.name for x in rs.replicas], 30)
        assert r.metrics.get("replica_restarts") == restarts
        (last,) = rs.healthy()
        with pytest.raises(ValueError):
            r.remove_replica(last.name)
        with pytest.raises(KeyError):
            r.remove_replica("ef.nope")
    finally:
        r.shutdown(drain=True, timeout=30.0)


# ---------------------------------------------------------------------------
# disaggregated prefill/decode and prefix affinity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_disaggregated_prefill_decode(pair, pkg):
    """Every request's prefill leg runs on the prefill replica and its
    decode leg adopts the migrated KV; tokens equal a colocated fleet's
    (tolerance 0)."""
    prompts = [prompt(90 + i, 9 + 3 * i) for i in range(4)]
    kw = dict(engine_kw=dict(ENGINE, prefill_chunk=4))
    col = _router(pkg, pair, name="co", **kw)
    try:
        refs = [np.asarray(col.submit(p, max_new_tokens=5).result(120))
                for p in prompts]
    finally:
        col.shutdown(drain=True, timeout=30.0)
    r = _router(pkg, pair, name="dg", disagg=True,
                roles=["prefill", "decode"],
                role_kw={"prefill": dict(prefill_chunk=16),
                         "decode": dict(prefill_chunk=4)}, **kw)
    try:
        outs = [np.asarray(r.submit(p, max_new_tokens=5).result(120))
                for p in prompts]
        for o, ref in zip(outs, refs):
            np.testing.assert_array_equal(o, ref)
        pre, dec = (x.engine for x in r.replica_set.replicas)
        assert pre.prefill_chunk == 16 and dec.prefill_chunk == 4
        assert dec.metrics.get("kv_migrations") == len(prompts)
        assert pre.queue is not dec.queue
    finally:
        r.shutdown(drain=True, timeout=30.0)


def test_prefix_affinity_sticks_and_a_fault_degrades_one_decision(pair):
    """Turn 1 lands on r1 (r0 made to look loaded); turn 2, which
    least-loaded placement would send to r0, follows its prefix to r1;
    an affinity fault sends one decision to least-loaded placement."""
    r = _router("port", pair, name="af", prefix_affinity=True)
    r0, r1 = r.replica_set.replicas
    try:
        base = prompt(5, 17)
        with r._lock:
            r0.load += 5
        try:
            turn1 = np.asarray(r.submit(base, max_new_tokens=3)
                               .result(120))
        finally:
            with r._lock:
                r0.load -= 5
        assert set(r._affinity.values()) == {"af.r1"}
        turn2 = np.concatenate([turn1, prompt(6, 4)])
        out = np.asarray(r.submit(turn2, max_new_tokens=3).result(120))
        assert r.metrics.get("affinity_hits") == 1
        assert r.snapshot()["affinity"]["per_replica"]["af.r1"]["hits"] \
            == 1
        assert r1.engine.prefix_lookups >= 2     # both turns on r1
        assert r0.engine.prefix_lookups == 0
        with faults.ChaosSchedule("serving.affinity@1:raise") as ch:
            again = np.asarray(r.submit(turn2, max_new_tokens=3)
                               .result(120))
            ch.verify()
        np.testing.assert_array_equal(again, out)
        assert r.metrics.get("affinity_faults") == 1
        assert r0.engine.prefix_lookups == 1     # least-loaded: r0
    finally:
        r.shutdown(drain=True, timeout=30.0)


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, name, index):
        self.name, self.index, self.load = name, index, 0


class _FakeFleet:
    def __init__(self, n):
        self.replicas = [_FakeReplica(f"f.r{i}", i) for i in range(n)]
        self.adds, self.removed = 0, []
        self.flight = 0

    def live_replicas(self):
        return len(self.replicas)

    member_replicas = live_replicas

    def healthy(self):
        return list(self.replicas)

    def capacity(self):
        return len(self.replicas) * 66

    def slot_capacity(self):
        return len(self.replicas) * 2

    def in_flight(self):
        return self.flight

    def add_replica(self):
        self.adds += 1
        self.replicas.append(_FakeReplica(f"f.r{len(self.replicas)}",
                                          len(self.replicas)))

    def remove_replica(self, name, drain=True):
        self.removed.append((name, drain))
        self.replicas = [r for r in self.replicas if r.name != name]


class _FakeRouter:
    def __init__(self, n, metrics):
        self.replica_set = _FakeFleet(n)
        self.metrics = metrics
        self.brownout_active = False
        self.in_flight = 0
        self.name = "f"
        self.autoscaler = None


def _autoscale_trace(pkg):
    """A scripted day: SLO burn, backlog, brownout, then idleness; the
    decision, target and signals after every tick."""
    mod = tserving if pkg == "port" else jserving
    fr = _FakeRouter(1, mod.ServingMetrics())
    asc = mod.Autoscaler(fr, min_replicas=1, max_replicas=3,
                         slo_p99_ms=100, cooldown_s=1.0, clock=lambda: 0.0)
    out = []
    script = [(0.0, "burn"), (0.5, "burn"), (1.5, "burn"), (3.0, "burn"),
              (4.5, "flight"), (6.0, "brown"), (8.0, "quiet"),
              (9.5, "quiet"), (11.0, "quiet"), (12.5, "quiet"),
              (14.0, "quiet")]
    for now, what in script:
        fr.in_flight = 40 if what == "flight" else 0
        fr.brownout_active = what == "brown"
        if what == "burn":
            for _ in range(8):
                fr.metrics.inc("fleet_completed")
                fr.metrics.observe_latency("e2e", 0.4)
        sig = asc.tick(now=now)
        if asc._scale_thread is not None:
            asc._scale_thread.join(10.0)
            assert not asc._scale_thread.is_alive()
        out.append((now, dict(asc.decisions), asc.target,
                    fr.replica_set.adds, list(fr.replica_set.removed),
                    {k: sig[k] for k in ("over_slo", "overloaded", "idle",
                                         "live", "members")}))
    asc.close()
    return out, asc


def test_autoscaler_decisions_match_reference():
    """Exact: the same decisions, targets and signals each tick."""
    port, asc = _autoscale_trace("port")
    ref, _ = _autoscale_trace("reference")
    assert port == ref
    assert asc.decisions["up"] >= 2 and asc.decisions["down"] >= 1
    assert monitor.stat_get("fleet.target_replicas") == asc.target


def test_autoscaler_grows_and_shrinks_a_real_fleet(pair):
    """One real tick under an injected backlog grows the fleet (the
    build runs on the autoscaler's thread); one tick after a quiet
    cooldown drains the newcomer out."""
    r = _router("port", pair, name="as")
    clock = [0.0]
    asc = tserving.Autoscaler(r, min_replicas=2, max_replicas=3,
                              slo_p99_ms=60000.0, cooldown_s=1.0,
                              backlog_factor=1.0, clock=lambda: clock[0])
    r.autoscaler = None       # ticked by hand, not by the supervisor
    try:
        with faults.inject("serving.replica_step@*:delay:0.05"):
            futs = [r.submit(prompt(40 + i, 6), max_new_tokens=6)
                    for i in range(8)]
            sig = asc.tick()
            assert sig["overloaded"] and asc.decisions["up"] == 1
            asc._scale_thread.join(60.0)
            assert not asc._scale_thread.is_alive()
            for fut in futs:
                fut.result(120)
        assert r.replica_set.member_replicas() == 3
        clock[0] = 5.0
        assert asc.tick()["idle"]          # idleness starts here
        clock[0] = 6.5
        asc.tick()
        assert asc.decisions["down"] == 1
        assert r.replica_set.member_replicas() == 2   # r2 draining
        assert _wait(lambda: [x.name for x in r.replica_set.replicas]
                     == ["as.r0", "as.r1"], 30)
    finally:
        asc.close()
        r.shutdown(drain=True, timeout=30.0)


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------


def test_launch_counter_is_exact_under_concurrent_callers():
    """8 threads x 10 000 bumps of the shared counter helper, with a
    short switch interval so a read-add-store would lose counts."""
    import sys

    saved = quant_ops.dequant_matmul.launches
    counts = {"B1": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        quant_ops.dequant_matmul.launches = 0

        def bump():
            for _ in range(10_000):
                _launch.count(quant_ops.dequant_matmul)
                _launch.count(counts, "B1")

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        assert quant_ops.dequant_matmul.launches == 80_000
        assert counts["B1"] == 80_000
    finally:
        sys.setswitchinterval(interval)
        quant_ops.dequant_matmul.launches = saved
