"""Port parity: paddle_tpu_torch's gang supervision (`distributed.gang`,
`distributed.elastic`, `checkpoint.GangCheckpointManager`) against
paddle_tpu's, on the CPU — the port's counterpart of tests/test_gang.py
without its p2p-mailbox tests (the mailbox waits with the parameter
server's transport).

- The typed errors: `CollectiveTimeoutError` / `PeerGoneError` are
  retriable and keep the port's `ExecutionTimeoutError` /
  `UnavailableError` bases; `deadline_guard` / `call_with_deadline` as
  the reference's tests pin them, and a transport error that says a
  peer's connection closed becomes `PeerGoneError`.
- `allreduce_host` on 3 gloo ranks equals the reference's mailbox
  collective on the same arrays bit for bit (rtol 0, atol 0), under
  sum, mean, max and min; a barrier the last rank never enters raises a
  typed retriable error on every live rank within the deadline (plus 2
  s of slack for the process); an injected delay past
  FLAGS_dist_timeout_s raises on every rank.
- `GangWorker`'s beat record is byte-compatible with the reference's
  `ElasticManager` both ways; its ``gang.heartbeat`` drop, and its
  deregistration on preemption.
- `terminate_all` SIGKILLs and reaps a child that ignores SIGTERM.
- The gang checkpoint: the commit barrier, its timeout, the newest
  globally committed step, the remap onto a smaller writer world, a
  digest mismatch; a GANG marker equal to the reference's (digests and
  combined digest) for the same numpy states.
- The supervisor: the reference's `GangSupervisor` and the port's run
  the same stdlib-only child script and must agree on the return code
  and the `snapshot()` fields (generation, restarts, world, quarantine)
  for restart-then-success, an exhausted budget, watermark hang
  detection, quarantine and shrink, and the membership verdict; the
  ``gang.restart`` site, an unformable ``min_np``, the gang metrics in
  `snapshot()` and Prometheus, and restart time counted as ``restart``
  in goodput.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.distributed import gang as jgang
from paddle_tpu.distributed import preempt as jpreempt

from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import elastic as telastic
from paddle_tpu_torch.distributed import gang as tgang
from paddle_tpu_torch.distributed import preempt
from paddle_tpu_torch.framework import errors, faults, flags, monitor

from torch_dist_workers import run_ranks

PAYLOAD = "torch_gang_payload"


@pytest.fixture(autouse=True)
def _restore_globals():
    prev = flags.get_flags(["FLAGS_dist_timeout_s"])
    specs = (faults._specs[:], dict(faults._hits), faults._env_loaded)
    yield
    flags.set_flags(prev)
    faults._specs[:] = specs[0]
    faults._hits.clear()
    faults._hits.update(specs[1])
    faults._env_loaded = specs[2]
    preempt.clear()
    jpreempt.clear()


# ---------------------------------------------------------------------------
# typed deadline errors
# ---------------------------------------------------------------------------


def test_typed_errors_are_retriable_with_the_ports_bases():
    assert tgang.CollectiveTimeoutError.retriable is True
    assert tgang.PeerGoneError.retriable is True
    assert issubclass(tgang.CollectiveTimeoutError,
                      errors.ExecutionTimeoutError)
    assert issubclass(tgang.PeerGoneError, errors.UnavailableError)
    # the same builtin bases as the reference's
    for t, j in ((tgang.CollectiveTimeoutError, jgang.CollectiveTimeoutError),
                 (tgang.PeerGoneError, jgang.PeerGoneError)):
        assert issubclass(t, TimeoutError) == issubclass(j, TimeoutError)
        assert issubclass(t, RuntimeError) == issubclass(j, RuntimeError)


def test_collective_timeout_error_is_typed_retriable():
    before = monitor.stat_get("gang.collective_timeouts")
    with faults.ChaosSchedule("dist.allreduce@1:delay:0.2") as ch:
        with pytest.raises(tgang.CollectiveTimeoutError) as ei:
            tgang.deadline_guard("dist.allreduce", 0.05)
        ch.verify()
    assert ei.value.retriable is True
    assert monitor.stat_get("gang.collective_timeouts") == before + 1


def test_deadline_guard_disabled_and_remaining():
    assert tgang.deadline_guard("dist.allreduce", 0) is None
    left = tgang.deadline_guard("dist.allreduce", 5.0)
    assert 0 < left <= 5.0
    with pytest.raises(ValueError):
        tgang.deadline_guard("dist.p2p_send", 1.0)


def test_call_with_deadline_inline_result_error_and_timeout():
    assert tgang.call_with_deadline(lambda: 7, None, "x") == 7
    assert tgang.call_with_deadline(lambda: 7, 1.0, "x") == 7
    with pytest.raises(ValueError):
        tgang.call_with_deadline(
            lambda: (_ for _ in ()).throw(ValueError("b")), 1.0, "x")
    ev = threading.Event()
    with pytest.raises(tgang.CollectiveTimeoutError):
        tgang.call_with_deadline(ev.wait, 0.05, "stuck-op")
    ev.set()


@pytest.mark.parametrize("deadline", [None, 1.0])
def test_closed_connection_becomes_peer_gone(deadline):
    before = monitor.stat_get("gang.peer_gone")

    def gone():
        raise RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection "
                           "closed by peer [127.0.0.1]:1234")

    with pytest.raises(tgang.PeerGoneError) as ei:
        tgang.call_with_deadline(gone, deadline, "dist.allreduce")
    assert ei.value.retriable and "dist.allreduce" in str(ei.value)
    assert monitor.stat_get("gang.peer_gone") == before + 1
    # any other transport error comes through as it is
    with pytest.raises(RuntimeError, match="shape"):
        tgang.call_with_deadline(
            lambda: (_ for _ in ()).throw(RuntimeError("bad shape")),
            deadline, "dist.allreduce")


# ---------------------------------------------------------------------------
# host collectives over the default process group
# ---------------------------------------------------------------------------


def _ref_allreduce(arrays, op):
    """The reference's mailbox all-reduce of `arrays`, one thread a
    rank."""
    from paddle_tpu.distributed.p2p import _Mailbox

    n = len(arrays)
    eps = ["127.0.0.1:%d" % p for p in jgang._free_ports(n)]
    boxes = [_Mailbox(types.SimpleNamespace(
        rank=r, world_size=n, current_endpoint=eps[r],
        trainer_endpoints=eps)) for r in range(n)]
    out = [None] * n

    def run(r):
        out[r] = jgang.allreduce_host(arrays[r], op, rank=r, world=n,
                                      deadline_s=20.0, box=boxes[r])

    try:
        ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
        [t.start() for t in ts]
        [t.join(30.0) for t in ts]
    finally:
        for b in boxes:
            b._tcp.shutdown()
            b._tcp.server_close()
    return out


def test_allreduce_host_equals_the_reference_bitwise(tmp_path):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(2, 3) * 10 ** r for r in range(3)]
    ops = ("sum", "mean", "max", "min")
    got = run_ranks(3, f"{PAYLOAD}:host_allreduce", (arrays, ops),
                    str(tmp_path), timeout=120)
    for op in ops:
        want = _ref_allreduce(arrays, op)
        for r in range(3):
            np.testing.assert_array_equal(got[r][op], want[r])
            assert got[r][op].dtype == want[r].dtype
    # the order of the sum is the reference's (rank 0 + 1, then + 2)
    np.testing.assert_array_equal(got[0]["sum"],
                                  (arrays[0] + arrays[1]) + arrays[2])


def test_barrier_deadline_unblocks_every_live_rank(tmp_path):
    deadline = 1.0
    got = run_ranks(3, f"{PAYLOAD}:host_barrier_missing", (deadline,),
                    str(tmp_path), timeout=120, hard_exit=True)
    for r in (0, 1):
        name, retriable, took = got[r]
        assert name in ("CollectiveTimeoutError", "PeerGoneError"), got[r]
        assert retriable is True
        assert took < deadline + 2.0, got[r]


def test_barrier_injected_delay_past_flag_raises_on_every_rank():
    flags.set_flags({"FLAGS_dist_timeout_s": 0.05})
    errs = {}
    with faults.ChaosSchedule("dist.barrier@1:delay:0.2",
                              "dist.barrier@2:delay:0.2") as ch:
        for r in (0, 1):
            with pytest.raises(tgang.CollectiveTimeoutError) as ei:
                tgang.barrier_host(rank=r, world=2)
            errs[r] = ei.value
        ch.verify()
    assert all(e.retriable for e in errs.values())


def test_allreduce_fault_is_retriable_at_step_boundary():
    """A fault-injected dist.allreduce surfaces as a retriable error at
    the step boundary; retrying the step gives a bitwise-identical
    trajectory (the reference's test, world 1)."""

    def train():
        w = np.linspace(0.0, 1.0, 4)
        for step in range(4):
            for _ in range(3):
                try:
                    g = tgang.allreduce_host(w * 0.25 + step, "sum",
                                             rank=0, world=1,
                                             deadline_s=0.05)
                    break
                except tgang.CollectiveTimeoutError as e:
                    assert e.retriable
            else:
                raise AssertionError("step never succeeded")
            w = w - 0.1 * g
        return w

    clean = train()
    with faults.ChaosSchedule("dist.allreduce@2:delay:0.2") as ch:
        faulted = train()
        ch.verify()
    np.testing.assert_array_equal(clean, faulted)


# ---------------------------------------------------------------------------
# gang worker heartbeats and the elastic registry
# ---------------------------------------------------------------------------


def test_gang_worker_beat_is_read_by_the_reference_elastic_manager(tmp_path):
    gw = tgang.GangWorker(gang_dir=str(tmp_path), rank=0)
    beat = tmp_path / "rank-0.beat"
    with faults.ChaosSchedule("gang.heartbeat@1:drop") as ch:
        gw.beat(step=3)   # dropped: the supervisor sees a stall
        assert not beat.exists()
        gw.beat(step=4)
        ch.verify()
    rec = json.loads(beat.read_text())
    assert rec["step"] == 4 and rec["node"] == "rank-0"
    assert set(rec) == {"node", "ts", "step"}
    ref = jelastic.ElasticManager(str(tmp_path), node_id="__reader__")
    assert ref.live_nodes() == ["rank-0"]
    assert ref.records()["rank-0"]["step"] == 4
    # and the other way: the reference's writer, the port's reader
    jelastic.ElasticManager(str(tmp_path), node_id="rank-1").beat(step=9)
    port = telastic.ElasticManager(str(tmp_path), node_id="__reader__")
    assert port.live_nodes() == ["rank-0", "rank-1"]
    assert port.records()["rank-1"]["step"] == 9


def test_elastic_beat_drop_and_verdicts(tmp_path):
    em = telastic.ElasticManager(str(tmp_path), node_id="a", min_np=1)
    with faults.ChaosSchedule("elastic.beat@1:drop") as ch:
        em.register()
        ch.verify()
    assert em.live_nodes() == []
    em.beat()
    assert em.watch() == telastic.ElasticStatus.HOLD   # first snapshot
    telastic.ElasticManager(str(tmp_path), node_id="b").beat()
    assert em.watch() == telastic.ElasticStatus.RESTART
    assert em.world() == (0, 2)


def test_gang_worker_deregisters_on_preemption(tmp_path):
    gw = tgang.GangWorker(gang_dir=str(tmp_path), rank=0)
    gw.beat(step=1)
    assert (tmp_path / "rank-0.beat").exists()
    preempt.request(reason="test")
    assert not (tmp_path / "rank-0.beat").exists()


# ---------------------------------------------------------------------------
# coordinated teardown
# ---------------------------------------------------------------------------


def test_terminate_all_sigkills_sigterm_ignorer_and_reaps():
    p = subprocess.Popen([
        sys.executable, "-c",
        "import signal, time; "
        "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
        "print('armed', flush=True); time.sleep(600)"],
        stdout=subprocess.PIPE)
    assert p.stdout.readline().strip() == b"armed"
    t0 = time.monotonic()
    tgang.terminate_all([p], grace=0.5)
    assert time.monotonic() - t0 < 10.0
    assert p.returncode == -signal.SIGKILL
    with pytest.raises(ChildProcessError):
        os.waitpid(p.pid, os.WNOHANG)


# ---------------------------------------------------------------------------
# gang commit barrier + globally consistent resume
# ---------------------------------------------------------------------------


def _both_save(mgrs, step, states):
    errs = []

    def _s(m, st):
        try:
            m.save(step, st)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=_s, args=(m, st))
          for m, st in zip(mgrs, states)]
    [t.start() for t in ts]
    [t.join(30.0) for t in ts]
    assert not errs, errs


def _managers(cls, path, world=2):
    return [cls(str(path), r, world, barrier_timeout_s=20.0)
            for r in range(world)]


def test_commit_barrier_makes_step_globally_readable(tmp_path):
    mgrs = _managers(tckpt.GangCheckpointManager, tmp_path)
    states = [{"w": np.full(4, float(r + 1))} for r in (0, 1)]
    before = monitor.stat_get("gang.commits")
    _both_save(mgrs, 5, states)
    assert monitor.stat_get("gang.commits") == before + 2
    for m in mgrs:
        assert m.latest_committed_step() == 5
    marker = mgrs[0].marker(5)
    assert marker["world"] == 2 and set(marker["digests"]) == {"0", "1"}


def test_gang_marker_equals_the_reference(tmp_path):
    rng = np.random.RandomState(4)
    states = [{"w": rng.randn(3, 5), "b": {"x": rng.randn(2).astype(
        np.float32), "n": np.arange(4, dtype=np.int32)}} for _ in (0, 1)]
    _both_save(_managers(tckpt.GangCheckpointManager, tmp_path / "t"), 2,
               states)
    _both_save(_managers(jckpt.GangCheckpointManager, tmp_path / "j"), 2,
               states)
    got = tckpt.GangCheckpointManager(str(tmp_path / "t"), 0, 2).marker(2)
    want = jckpt.GangCheckpointManager(str(tmp_path / "j"), 0, 2).marker(2)
    assert got["digests"] == want["digests"]
    assert got["digest"] == want["digest"]
    assert (got["step"], got["world"]) == (want["step"], want["world"])
    for r in (0, 1):
        assert tckpt._combined_digest(tckpt.leaf_digests(states[r])) == \
            jckpt._combined_digest(jckpt.leaf_digests(states[r]))


def test_commit_barrier_times_out_when_a_rank_never_writes(tmp_path):
    m0 = tckpt.GangCheckpointManager(str(tmp_path), 0, 2,
                                     barrier_timeout_s=0.3)
    with pytest.raises(tgang.CollectiveTimeoutError) as ei:
        m0.save(2, {"w": np.ones(3)})
    assert ei.value.retriable
    assert m0.latest_committed_step() is None  # no GANG marker
    assert m0.local.is_readable(2)


def test_commit_barrier_passes_the_barrier_site(tmp_path):
    m0 = tckpt.GangCheckpointManager(str(tmp_path), 0, 1,
                                     barrier_timeout_s=0.05)
    with faults.ChaosSchedule("dist.barrier[gang-commit]@1:delay:0.2") as ch:
        with pytest.raises(tgang.CollectiveTimeoutError):
            m0.save(1, {"w": np.ones(2)})
        ch.verify()


def test_restore_uses_newest_globally_committed_step(tmp_path):
    mgrs = _managers(tckpt.GangCheckpointManager, tmp_path)
    committed = [{"w": np.arange(4) * 1.0}, {"w": np.arange(4) * 2.0}]
    _both_save(mgrs, 3, committed)
    # rank 1 gets further alone, then dies before the barrier
    mgrs[1].local.save(4, {"w": np.arange(4) * 9.0})
    mgrs[1]._write_json(mgrs[1]._rank_marker(4, 1),
                        {"rank": 1, "digest": "dead", "ts": 0})
    for r in (0, 1):
        step, st = mgrs[r].restore({"w": np.zeros(4)})
        assert step == 3
        np.testing.assert_array_equal(st["w"], committed[r]["w"])
    before = monitor.stat_get("gang.restores")
    mgrs[0].restore({"w": np.zeros(4)})
    assert monitor.stat_get("gang.restores") == before + 1


def test_restore_remaps_ranks_onto_smaller_writer_world(tmp_path):
    mgrs = _managers(tckpt.GangCheckpointManager, tmp_path)
    _both_save(mgrs, 1, [{"w": np.full(2, 10.0)}, {"w": np.full(2, 20.0)}])
    m2 = tckpt.GangCheckpointManager(str(tmp_path), 2, 3)
    step, st = m2.restore({"w": np.zeros(2)})
    assert step == 1
    np.testing.assert_array_equal(st["w"], np.full(2, 10.0))


def test_restore_digest_mismatch_is_detected(tmp_path):
    mgrs = _managers(tckpt.GangCheckpointManager, tmp_path)
    _both_save(mgrs, 7, [{"w": np.ones(3)}, {"w": np.ones(3) * 2}])
    marker = mgrs[0].marker(7)
    marker["digests"]["0"] = "0" * 64
    mgrs[0]._write_json(mgrs[0]._gang_marker(7), marker)
    with pytest.raises(ValueError, match="digest mismatch"):
        mgrs[0].restore({"w": np.zeros(3)})


# ---------------------------------------------------------------------------
# supervisor state machine: both packages on the same stdlib children
# ---------------------------------------------------------------------------

_BEATER = r"""
import json, os, sys, time
slot = os.environ["PADDLE_GANG_SLOT"]
gang = os.environ["PADDLE_GANG_DIR"]
attempt = int(os.environ.get("PADDLE_GANG_ATTEMPT", "1"))
def beat(step):
    rec = {"node": "rank-" + slot, "ts": time.time(), "step": step}
    tmp = os.path.join(gang, "rank-" + slot + ".beat.tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, os.path.join(gang, "rank-" + slot + ".beat"))
"""


def _sup(module, path, script, nranks=2, **kw):
    kw.setdefault("max_restarts", 2)
    kw.setdefault("hang_secs", 0.0)
    kw.setdefault("grace_s", 2.0)
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_max_s", 0.02)
    kw.setdefault("stderr", io.StringIO())
    return module.GangSupervisor([sys.executable, "-c", _BEATER + script],
                                 nranks, gang_dir=str(path / "gang"), **kw)


def _both(tmp_path, script, **kw):
    """Run the port's and the reference's supervisor on `script`; returns
    (port supervisor, its code) after checking both agree."""
    out = {}
    for name, mod in (("port", tgang), ("ref", jgang)):
        sup = _sup(mod, tmp_path / name, script, **kw)
        out[name] = (sup, sup.run())
    (tsup, tcode), (jsup, jcode) = out["port"], out["ref"]
    assert tcode == jcode, (tcode, jcode, tsup.stderr.getvalue(),
                            jsup.stderr.getvalue())
    ts, js = tsup.snapshot(), jsup.snapshot()
    for key in ("generation", "restarts", "world", "quarantined"):
        assert ts[key] == js[key], (key, ts, js)
    return tsup, tcode


def test_supervisor_restart_then_success(tmp_path):
    before = monitor.stat_get("gang.restarts")
    sup, code = _both(tmp_path, """
beat(0)
if slot == "1" and attempt == 1:
    sys.exit(9)
time.sleep(0.4)
beat(1)
""")
    assert code == 0
    assert sup.restarts == 1 and sup.generation == 2
    assert monitor.stat_get("gang.restarts") == before + 1
    err = sup.stderr.getvalue()
    assert "exited with code 9; terminating the pod" in err
    assert "elastic restart 1/2 after exit code 9" in err


def test_supervisor_budget_exhaustion_propagates_code(tmp_path):
    sup, code = _both(tmp_path, """
beat(0)
if slot == "1":
    sys.exit(7)
time.sleep(5)
""", max_restarts=1)
    assert code == 7 and sup.restarts == 1
    assert "restart budget exhausted" in sup.stderr.getvalue()


def test_supervisor_hang_detection_via_step_watermark(tmp_path):
    sup, code = _both(tmp_path, """
if attempt > 1:
    beat(0); sys.exit(0)
step = 0
for i in range(200):
    beat(step)
    if not (slot == "1" and i >= 3):
        step += 1
    time.sleep(0.05)
""", hang_secs=0.6, max_restarts=2)
    assert code == 0 and sup.restarts == 1
    assert "stalled" in sup.stderr.getvalue()


def test_supervisor_quarantines_flaky_slot_and_shrinks_world(tmp_path):
    before = monitor.stat_get("gang.quarantined")
    sup, code = _both(tmp_path, """
beat(0)
if os.environ["PADDLE_TRAINERS_NUM"] == "1":
    sys.exit(0)
if slot == "1":
    sys.exit(3)
time.sleep(5)
""", min_np=1, max_restarts=4, quarantine_after=2)
    assert code == 0
    assert sup.quarantined == {1} and sup.world_size() == 1
    assert monitor.stat_get("gang.quarantined") == before + 1
    assert "quarantined" in sup.stderr.getvalue()


def test_supervisor_membership_verdict_triggers_reformation(tmp_path):
    sup, code = _both(tmp_path, """
if attempt > 1:
    beat(0); sys.exit(0)
for i in range(200):
    beat(i)
    if slot == "1" and i == 20:
        os.remove(os.path.join(gang, "rank-1.beat"))
        time.sleep(20)
    time.sleep(0.05)
""", max_restarts=2, hang_secs=0.0)
    assert code == 0 and sup.restarts == 1
    assert "membership changed" in sup.stderr.getvalue()


def test_supervisor_gang_restart_site_fires(tmp_path):
    with faults.ChaosSchedule("gang.restart@1:delay:0.01") as ch:
        sup = _sup(tgang, tmp_path, """
beat(0)
if slot == "0" and attempt == 1:
    sys.exit(2)
""")
        assert sup.run() == 0
        ch.verify()


def test_supervisor_min_np_unformable_raises(tmp_path):
    with pytest.raises(ValueError, match="min_np"):
        tgang.GangSupervisor(["true"], 2, gang_dir=str(tmp_path / "g"),
                             min_np=3)


def test_supervisor_spawn_env_contract(tmp_path):
    """Each child gets the launcher's env contract, as the reference's."""
    script = """
keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
        "PADDLE_LOCAL_RANK", "PADDLE_GANG_SLOT", "PADDLE_GANG_ATTEMPT")
with open(os.path.join(gang, "env." + slot), "w") as f:
    json.dump({k: os.environ[k] for k in keys}, f)
eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
assert os.environ["PADDLE_CURRENT_ENDPOINT"] == eps[int(slot)]
assert os.environ["PADDLE_MASTER"] == eps[0]
"""
    sup = _sup(tgang, tmp_path, script)
    assert sup.run() == 0
    for slot in ("0", "1"):
        env = json.loads((tmp_path / "gang" / f"env.{slot}").read_text())
        assert env["PADDLE_TRAINER_ID"] == slot == env["PADDLE_GANG_SLOT"]
        assert env["PADDLE_TRAINERS_NUM"] == "2"
        assert env["PADDLE_GANG_ATTEMPT"] == "1"


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_gang_metrics_in_snapshot_and_prometheus(tmp_path):
    from paddle_tpu_torch.observe import export

    with faults.ChaosSchedule("dist.allreduce@1:delay:0.2"):
        with pytest.raises(tgang.CollectiveTimeoutError):
            tgang.allreduce_host(np.ones(2), rank=0, world=2,
                                 deadline_s=0.05)
    snap = export.snapshot()
    assert snap["gang"]["collective_timeouts"] >= 1
    text = export.prometheus_text()
    for fam in ("paddle_gang_restarts_total",
                "paddle_gang_collective_timeouts_total",
                "paddle_gang_peer_gone_total",
                "paddle_gang_commits_total",
                "paddle_gang_restart_lost_seconds_total"):
        assert fam in text, fam
    # a live supervisor's heartbeat ages feed the per-rank gauge
    sup = _sup(tgang, tmp_path, "beat(0)\ntime.sleep(1.0)\n")
    sup._spawn_all()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                len(tgang.heartbeat_ages()) < 2:
            time.sleep(0.05)
        ages = export.snapshot()["gang"]["heartbeat_ages"]
        assert set(ages) >= {"0", "1"}
        assert "paddle_gang_rank_heartbeat_age_seconds" in \
            export.prometheus_text()
    finally:
        sup.terminate()


def test_gang_restart_time_folds_into_goodput_as_restart(tmp_path):
    from paddle_tpu_torch.observe import export

    sup = _sup(tgang, tmp_path, """
beat(0)
if slot == "1" and attempt == 1:
    sys.exit(4)
""")
    assert sup.run() == 0
    assert monitor.stat_get("gang.restart_lost_ms") > 0
    g = export.goodput()
    assert g["categories_s"]["restart"] > 0.0
