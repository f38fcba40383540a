"""Port parity: paddle_tpu_torch's tenancy (`TenantSpec`,
`TenantDirectory`, `TenantFairQueue`, `ArtifactCatalog`,
`AdapterRollout`), the open-loop workload simulator and the HTTP front,
on the CPU against paddle_tpu's (tiny GPT: vocab 97, hidden 64, 2
layers, the same numpy weights).

- `TenantFairQueue`: the same pop order for the same submissions
  (weights, quantum, requeued heads, cancelled and expired entries), the
  same budget sheds and Retry-After; a ``serving.admit_tenant`` drop
  sheds one tenant.
- The token bucket: the same (ok, wait) sequence under a fake clock
  (exact: the same float formulas).
- `ArtifactCatalog`: identical `lines()` and snapshots (digests are
  sha256 strings of the same bytes).
- `AdapterRollout` over the fleet's LoRA banks: canary, wave, commit;
  a faulted wave swaps the old bank back bit for bit.
- Tier brownout on a tenant fleet sheds bronze and serves gold, in both
  packages.
- `Scenario.trace()`: identical arrivals bit for bit (times, users,
  prompts, lengths, priorities, sessions, tenants) for swing, diurnal,
  the three arrival processes, multi-turn sessions and a tenant mix,
  and identical `to_json`; `replay` is open loop.
- `http_front`: ``X-Tenant`` billing, the budgeted tenant's 429 with
  its own Retry-After, 400 on a malformed body, /metrics and
  /v1/version.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.framework import faults as jfaults
from paddle_tpu.serving import tenancy as jtenancy

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.framework import faults
from paddle_tpu_torch.serving import tenancy as ttenancy
from torch_parity import VOCAB, build_pair, prompt

ENGINE = dict(max_slots=2, block_size=8)
RANK = 4
N_ADAPTERS = 3
MODS = {"port": tserving, "reference": jserving}


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


def _req(mod, tenant, max_new=4, n=4, timeout=None):
    return mod.Request(np.arange(1, n + 1, dtype=np.int32),
                       max_new_tokens=max_new, tenant=tenant,
                       timeout=timeout)


def _pop_order(mod):
    d = mod.TenantDirectory([mod.TenantSpec("flood", weight=1.0),
                             mod.TenantSpec("vip", weight=4.0),
                             mod.TenantSpec("mid", weight=2.0)])
    q = mod.TenantFairQueue(64, tenancy=d, quantum=8)
    reqs = []
    for i in range(12):
        reqs.append(q.submit(_req(mod, "flood", max_new=2 + i % 5)))
    for i in range(4):
        reqs.append(q.submit(_req(mod, "vip", n=3 + i)))
    for i in range(5):
        reqs.append(q.submit(_req(mod, "mid", max_new=6)))
    reqs.append(q.submit(_req(mod, None)))
    reqs[3].cancel()
    index = {r.id: i for i, r in enumerate(reqs)}
    order = []
    while q.depth:
        r = q.pop(timeout=0.5)
        if r is None:
            break
        order.append(index[r.id])
        if len(order) == 5:          # a pool-wait push-back of the head
            q.requeue(r)
            order.append(index[q.pop(timeout=0.5).id])
    return order, q.tenant_depths()


def test_fair_queue_pop_order_matches_reference():
    """Exact: the same indices in the same order."""
    port, ref = _pop_order(tserving), _pop_order(jserving)
    assert port == ref
    order, depths = port
    assert 3 not in order and depths == {}
    assert max(i for i, k in enumerate(order) if 12 <= k < 16) < 10


def test_budget_shed_and_admit_tenant_fault_match_reference():
    out = {}
    for pkg, mod in MODS.items():
        f = faults if pkg == "port" else jfaults
        d = mod.TenantDirectory([mod.TenantSpec(
            "tiny", budget_tokens_per_s=10, burst_s=1.0)])
        metrics = mod.ServingMetrics()
        q = mod.TenantFairQueue(64, tenancy=d, metrics=metrics)
        q.submit(_req(mod, "tiny", max_new=2))     # cost 6 of 10
        with pytest.raises(mod.TenantBudgetError) as ei:
            q.submit(_req(mod, "tiny", max_new=4))  # cost 8 > 4 left
        assert ei.value.status == 429 and ei.value.retriable
        assert 0 < ei.value.retry_after_s <= 1.0
        with f.ChaosSchedule("serving.admit_tenant[noisy]@1:drop") as ch:
            with pytest.raises(mod.TenantBudgetError):
                q.submit(_req(mod, "noisy"))
            q.submit(_req(mod, "quiet"))
            ch.verify()
        snap = metrics.snapshot()
        out[pkg] = ({t: c["counters"] for t, c in snap["tenants"].items()},
                    metrics.get("rejected_budget"))
    assert out["port"] == out["reference"]
    assert out["port"][0]["noisy"]["shed"] == 1


class _Clock:
    """A stand-in for the `time` module inside tenancy.py."""

    def __init__(self):
        self.now = 50.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("burst", [1.0, 0.5])
def test_token_bucket_refill_matches_reference(monkeypatch, burst):
    """Exact: the same (ok, wait_s) and remaining budget at each step
    of a scripted clock."""
    seqs = {}
    for name, mod in (("port", ttenancy), ("ref", jtenancy)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        spec = mod.TenantSpec("b", budget_tokens_per_s=20, burst_s=burst)
        seq = []
        for dt, cost in ((0.0, 8), (0.0, 8), (0.0, 8), (0.1, 8),
                         (0.4, 30), (0.25, 5), (2.0, 1), (0.0, 19)):
            clock.now += dt
            seq.append((spec.try_debit(cost), spec.budget_remaining()))
        seqs[name] = seq
        assert mod.TenantSpec("u", budget_tokens_per_s=0).try_debit(1e9) \
            == (True, 0.0)
    assert seqs["port"] == seqs["ref"]
    assert any(not ok for (ok, _), _ in seqs["port"])


def test_directory_and_catalog_match_reference():
    out = {}
    for pkg, mod in MODS.items():
        d = mod.TenantDirectory({"a": {"weight": 3.0, "slo_class": "gold"},
                                 "b": mod.TenantSpec("b", priority=2)},
                                brownout_tier=2)
        d.resolve("auto")
        cat = mod.ArtifactCatalog()
        rng = np.random.RandomState(0)
        base = {"w": rng.randn(4, 3).astype(np.float32)}
        if pkg == "port":
            base = {"w": torch.as_tensor(base["w"])}
        cat.add("model", "base", values=base)
        cat.add("adapter", "bot", manifest={"lora_a": "ab" * 32})
        cat.add("adapter", "bot", manifest={"lora_a": "cd" * 32},
                version=5)
        cat.commit("adapter", "bot", 5)
        cat.retire("adapter", "bot", 1)
        with pytest.raises(ValueError):
            cat.add("adapter", "bot", manifest={"x": "0"}, version=2)
        with pytest.raises(KeyError):
            cat.get("adapter", "bot", 1)
        out[pkg] = (d.names(), d.snapshot(), d.resolve("a").tier,
                    cat.lines(), cat.snapshot(),
                    cat.get("model", "base").digest)
    assert out["port"] == out["reference"]


# ---------------------------------------------------------------------------
# a tenant fleet: tier brownout, adapter rollout
# ---------------------------------------------------------------------------


def _bank(seed, scale=0.5):
    rng = np.random.RandomState(seed)
    la = np.zeros((N_ADAPTERS, RANK, 64), np.float32)
    lb = np.zeros((N_ADAPTERS, VOCAB, RANK), np.float32)
    la[1:] = rng.randn(N_ADAPTERS - 1, RANK, 64) * scale
    lb[1:] = rng.randn(N_ADAPTERS - 1, VOCAB, RANK) * scale
    return la, lb


def _tenant_router(pkg, pair):
    jm, tm, _ = pair
    mod = MODS[pkg]
    ten = mod.TenantDirectory(
        [mod.TenantSpec("gold-co", weight=4.0, slo_class="gold",
                        priority=2),
         mod.TenantSpec("best-effort", weight=1.0, slo_class="bronze")],
        brownout_tier=1)
    kw = dict(engine_kw=dict(ENGINE, max_adapters=N_ADAPTERS,
                             lora_rank=RANK),
              tenancy=ten, hedge=False, name="tenfleet")
    if pkg == "port":
        return mod.Router(tm, 2, device="cpu", **kw).start()
    return mod.Router(jm, 2, **kw).start()


@pytest.mark.parametrize("pkg", list(MODS))
def test_tier_brownout_sheds_bronze_and_serves_gold(pair, pkg):
    mod = MODS[pkg]
    router = _tenant_router(pkg, pair)
    try:
        router.set_brownout(True)
        with pytest.raises(mod.BrownoutShedError):
            router.submit(prompt(1, 6), max_new_tokens=2,
                          tenant="best-effort")
        out = np.asarray(router.submit(prompt(1, 6), max_new_tokens=2,
                                       tenant="gold-co").result(60))
        assert out.size == 8
        router.set_brownout(None)
        snap = router.metrics.snapshot()
        assert snap["tenants"]["best-effort"]["counters"]["shed"] == 1
        assert snap["tenants"]["gold-co"]["counters"]["completed"] == 1
        for r in router.replica_set.replicas:
            assert isinstance(r.engine.queue, mod.TenantFairQueue)
    finally:
        router.shutdown(drain=True, timeout=30.0)


def test_adapter_rollout_commits_and_a_faulted_wave_rolls_back(pair):
    router = _tenant_router("port", pair)
    try:
        ro = tserving.AdapterRollout(router, name="support-bot")
        la, lb = _bank(31, 0.4)
        art = ro.roll_to(torch.as_tensor(la), torch.as_tensor(lb),
                         probe=prompt(2, 6))
        assert ro.state == "committed" and ro.error is None
        assert ro.catalog.serving_version("adapter", "support-bot") == \
            art.version
        engines = [r.engine for r in router.replica_set.healthy()]
        assert all(e.adapter_version == art.version for e in engines)
        for e in engines:
            np.testing.assert_array_equal(e._lora_a.numpy(), la)
        p = prompt(4, 6)
        before = [np.asarray(e.submit(p, max_new_tokens=8, adapter_id=1)
                             .result(60)) for e in engines]
        vers = [e.adapter_version for e in engines]
        la2, lb2 = _bank(77, 0.9)
        with faults.ChaosSchedule("serving.adapter_swap@2:raise") as ch:
            with pytest.raises(faults.FaultError):
                ro.roll_to(la2, lb2)
            ch.verify()
        assert ro.state == "rolled_back" and "FaultError" in ro.error
        after = [np.asarray(e.submit(p, max_new_tokens=8, adapter_id=1)
                            .result(60)) for e in engines]
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a, b)
        assert [e.adapter_version for e in engines] == vers
    finally:
        router.shutdown(drain=True, timeout=30.0)


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------


def _scenarios(mod):
    S = mod.Scenario
    return [
        S.swing(low_rps=4, high_rps=40, low_s=0.5, high_s=0.5, seed=3,
                vocab=VOCAB),
        S.diurnal(base_rps=2, peak_rps=12, period_s=3.0, seed=4),
        S(seed=5, phases=[{"duration_s": 2.0, "rate_rps": 9.0,
                           "arrival": "burst", "burst_n": 4}]),
        S(seed=6, phases=[{"duration_s": 2.0, "rate_rps": 9.0,
                           "arrival": "heavy_tail"}]),
        S(seed=7, multi_turn=True, n_users=6,
          phases=[{"duration_s": 1.5, "rate_rps": 5.0}]),
        S.swing(seed=8, vocab=VOCAB, low_s=1.0, high_s=1.0,
                tenants={"gold-co": {"weight": 1.0, "priority": 2},
                         "best-effort": {"weight": 3.0}}),
    ]


def test_workload_traces_match_reference_bit_for_bit():
    for ts, js in zip(_scenarios(tserving), _scenarios(jserving)):
        assert ts.to_json() == js.to_json()
        a, b = ts.trace(), js.trace()
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert (x.t, x.user, x.max_new, x.priority, x.session,
                    x.turn, x.tenant) == (y.t, y.user, y.max_new,
                                          y.priority, y.session, y.turn,
                                          y.tenant)
            assert x.prompt.dtype == y.prompt.dtype
            np.testing.assert_array_equal(x.prompt, y.prompt)
        again = tserving.Scenario.from_json(ts.to_json()).trace()
        assert [x.t for x in again] == [x.t for x in a]


def test_replay_is_open_loop():
    sc = tserving.Scenario(seed=1, phases=[{"duration_s": 0.3,
                                            "rate_rps": 40.0}])
    trace = sc.trace()
    calls = []

    def submit(arrival):
        calls.append(time.monotonic())
        if len(calls) % 3 == 0:
            raise tserving.QueueFullError("shed")
        return len(calls)

    recs = tserving.replay(submit, trace, time_scale=0.5)
    assert len(recs) == len(trace)
    assert sum(r["error"] is not None for r in recs) == len(trace) // 3
    assert all(r["t_submit"] >= r["arrival"].t * 0.5 - 1e-3
               for r in recs)


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------


def _post(port, body, headers=None):
    return urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})


def test_http_front_x_tenant_budget_429_with_its_retry_after(pair):
    _, tm, _ = pair
    ten = tserving.TenantDirectory(
        [tserving.TenantSpec("metered", budget_tokens_per_s=12,
                             burst_s=1.0)])
    srv = tserving.Server(tm, replicas=2, max_slots=2, block_size=8,
                          tenancy=ten, device="cpu",
                          fleet=dict(hedge=False, name="hf")).start()
    httpd = tserving.http_front(srv, port=0)
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(_post(port, {
                "prompt": [1, 2, 3], "max_new_tokens": 4},
                {"X-Tenant": "metered"}), timeout=60) as r:
            assert len(json.loads(r.read())["ids"]) == 7
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(_post(port, {
                "prompt": [1, 2, 3], "max_new_tokens": 8,
                "tenant": "metered"}), timeout=60)
        assert ei.value.code == 429
        wait = float(ei.value.headers["Retry-After"])
        # the bucket is short 11 - 5 = 6 tokens at 12 tokens/s
        assert 0.3 < wait <= 0.5
        payload = json.loads(ei.value.read())
        assert payload["type"] == "TenantBudgetError"
        assert payload["retriable"] is True
        with urllib.request.urlopen(_post(port, {
                "prompt": [1, 2, 3], "max_new_tokens": 4}),
                timeout=60) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(_post(port, {"prompt": []}), timeout=60)
        assert ei.value.code == 400
        assert json.loads(ei.value.read())["retriable"] is False
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            snap = json.loads(r.read())
        assert snap["tenants"]["metered"]["counters"]["completed"] == 1
        assert snap["tenants"]["metered"]["counters"]["shed"] == 1
        assert len(snap["fleet"]["replicas"]) == 2
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/version", timeout=60) as r:
            info = json.loads(r.read())
        assert info["state"] == "static" and info["versions_live"] == [0]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown(drain=True)
