"""Gang-scheduled training supervision: collective deadlines, typed
peer-failure errors, and coordinated whole-gang restart (counterpart of
paddle_tpu/distributed/gang.py, with the same names, env contract,
monitor stats and messages).

Training ranks are not independent: one rank's death or hang makes
every peer's next collective undefined, so recovery is a coordinated,
checkpoint-consistent restart of the WHOLE gang. Three layers:

1. **Deadlines** - `deadline_guard` / `call_with_deadline` wrap every
   eager collective (`collective.all_reduce`, `collective.barrier`),
   the host collectives below and the gang checkpoint commit barrier
   with a per-call deadline (FLAGS_dist_timeout_s). A rank whose peer
   died mid-collective raises typed *retriable* `CollectiveTimeoutError`
   (the deadline expired) or `PeerGoneError` (the transport reported
   the peer's connection closed) instead of blocking forever.
2. **Gang supervision** - `GangSupervisor` owns all local ranks:
   per-rank heartbeat files + step-progress watermarks (the
   `elastic.ElasticManager` registry format), hang detection,
   coordinated SIGTERM->SIGKILL teardown of *all* ranks when any rank
   dies or stalls, restart under exponential backoff with a flaky-rank
   quarantine counter, and ElasticManager RESTART/HOLD verdicts wired
   into world re-formation within [min_np, max_np].
3. **Worker participation** - `GangWorker` is the rank side: one
   `beat()` per step boundary writes liveness + the step watermark, and
   a preemption deregisters the rank.

`allreduce_host` / `barrier_host` run over the default process group
(`init_parallel_env`; gloo for host arrays), where the reference rides
its p2p mailbox, which waits with the parameter server's transport: rank
0 receives every other rank's array in ascending rank order, reduces in
that order and sends the result back, so the result is bit for bit the
reference's. Recovery is checkpoint-based
(`checkpoint.GangCheckpointManager`: a step is committed only when
every rank wrote it, and a restarted gang restores from the newest
*globally* committed step).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
import weakref

import numpy as np

from ..framework import monitor as _monitor
from ..framework.errors import ExecutionTimeoutError, UnavailableError

__all__ = [
    "CollectiveTimeoutError", "PeerGoneError", "deadline_guard",
    "call_with_deadline", "GangWorker", "allreduce_host", "barrier_host",
    "GangSupervisor", "heartbeat_ages", "terminate_all",
]


class CollectiveTimeoutError(ExecutionTimeoutError):
    """An eager collective/barrier exceeded its per-call deadline
    (FLAGS_dist_timeout_s): a peer died or stalled mid-collective.
    Retriable — at a step boundary the caller may retry the op or exit
    and let the gang supervisor coordinate a restart."""

    retriable = True


class PeerGoneError(UnavailableError):
    """A peer's process is gone: the transport reported its connection
    closed mid-collective. Retriable for the same reason as
    CollectiveTimeoutError."""

    retriable = True


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


def _default_deadline():
    from ..framework import flags as _flags

    return _flags.flag("FLAGS_dist_timeout_s")


def _fire(site, tag):
    """Pass the fault site of a deadline-scoped op (the port has two:
    the p2p mailbox's sites wait with it)."""
    from ..framework import faults as _faults

    if site == "dist.allreduce":
        return _faults.fault_point("dist.allreduce", tag=tag)
    if site == "dist.barrier":
        return _faults.fault_point("dist.barrier", tag=tag)
    raise ValueError(f"no deadline-scoped site {site!r}")


def deadline_guard(site, deadline_s=None, tag=None):
    """Enter a deadline-scoped distributed op (`site`: "dist.allreduce"
    or "dist.barrier"): fire the fault site (a `delay` action eats the
    budget - the deterministic timeout path) and return the remaining
    per-call deadline in seconds, or None when deadlines are disabled
    (FLAGS_dist_timeout_s=0 and no explicit deadline). Raises
    CollectiveTimeoutError when the budget is already spent before the
    transport is even reached."""
    if deadline_s is None:
        deadline_s = _default_deadline()
    if not deadline_s or deadline_s <= 0:
        _fire(site, tag)
        return None
    start = time.monotonic()
    _fire(site, tag)
    remaining = deadline_s - (time.monotonic() - start)
    if remaining <= 0:
        _monitor.stat_add("gang.collective_timeouts")
        raise CollectiveTimeoutError(
            f"{site} exceeded its {deadline_s:.3f}s deadline before "
            "reaching the transport (injected slowness or a scheduler "
            "stall); the op is retriable at the next step boundary")
    return remaining


#: what the transports say when a peer's connection went away (gloo's
#: tcp pairs, NCCL's aborted communicators, the TCP store)
_GONE_WORDS = ("connection closed", "connection reset", "broken pipe",
               "closed by peer", "socket closed", "end of file",
               "connection refused", "communicator was aborted",
               "remote process exited", "no route to host")


def _peer_gone(err):
    """Whether the transport error `err` says a peer's process is gone."""
    text = str(err).lower()
    return isinstance(err, RuntimeError) and any(
        w in text for w in _GONE_WORDS)


def _typed(err, what):
    """`err` raised by a transport under `what`: a PeerGoneError when it
    says a peer is gone, else `err` itself."""
    if isinstance(err, (CollectiveTimeoutError, PeerGoneError)) or \
            not _peer_gone(err):
        return err
    _monitor.stat_add("gang.peer_gone")
    out = PeerGoneError(
        f"{what}: a peer's connection closed mid-collective ({err}); "
        "retriable (exit and let the gang supervisor restart)")
    out.__cause__ = err
    return out


def call_with_deadline(fn, deadline_s, what):
    """Run blocking transport work with a deadline. `fn` executes on a
    daemon worker thread; if it does not finish within `deadline_s` the
    caller unblocks with CollectiveTimeoutError while the thread is
    abandoned (the gang supervisor tears the process down anyway - a
    leaked blocked thread is strictly better than a rank wedged
    forever). `deadline_s=None` calls `fn` inline (deadlines off). A
    transport error that says a peer is gone is raised as
    PeerGoneError, any other error as it came."""
    if deadline_s is None:
        try:
            return fn()
        except RuntimeError as e:
            raise _typed(e, what) from None
    box = {}

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - reraised on caller
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True,
                         name=f"deadline:{what}")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        _monitor.stat_add("gang.collective_timeouts")
        raise CollectiveTimeoutError(
            f"{what} did not complete within its {deadline_s:.3f}s "
            "deadline - a peer is gone or stalled mid-collective; "
            "retriable (exit and let the gang supervisor restart)")
    if "error" in box:
        raise _typed(box["error"], what)
    return box.get("result")


# ---------------------------------------------------------------------------
# worker side: heartbeat + step watermark
# ---------------------------------------------------------------------------


class GangWorker:
    """Rank-side gang participation.

    One instance per training process; `beat(step=...)` at every step
    boundary writes the rank's liveness heartbeat AND its step-progress
    watermark into the supervisor's registry (the ElasticManager file
    format, so the elastic machinery reads the same files). A preemption
    (`preempt.request`) deregisters the rank immediately, so the
    supervisor and peers observe the membership change without waiting
    for the heartbeat to expire."""

    def __init__(self, gang_dir=None, rank=None, node_id=None,
                 heartbeat_interval=1.0, timeout=10.0):
        from .elastic import ElasticManager
        from .parallel import ParallelEnv

        gang_dir = gang_dir or os.environ.get("PADDLE_GANG_DIR")
        if not gang_dir:
            raise RuntimeError(
                "GangWorker needs a registry dir: pass gang_dir= or run "
                "under the gang supervisor (PADDLE_GANG_DIR)")
        if rank is None:
            rank = ParallelEnv().rank
        # the node id is keyed by SLOT (the supervisor's stable rank id
        # across world re-formations), falling back to the rank
        slot = os.environ.get("PADDLE_GANG_SLOT", str(rank))
        self.rank = int(rank)
        self.slot = int(slot)
        self.em = ElasticManager(
            gang_dir, node_id=node_id or f"rank-{slot}",
            heartbeat_interval=heartbeat_interval, timeout=timeout)
        from . import preempt as _preempt

        _preempt.on_preempt(self.deregister)

    def beat(self, step=None):
        """Heartbeat + step watermark. Passes the ``gang.heartbeat``
        fault site: ``drop`` skips the write (the supervisor sees this
        rank stall), ``delay`` models a slow registry filesystem,
        ``crash`` is death at the beat itself."""
        from ..framework import faults as _faults

        if _faults.fault_point("gang.heartbeat",
                               tag=str(self.slot)) is _faults.DROP:
            return
        self.em.beat(step=step)
        _monitor.stat_add("gang.heartbeats")

    def deregister(self):
        self.em.deregister()


# ---------------------------------------------------------------------------
# eager host collectives over the default process group
# ---------------------------------------------------------------------------
#
# Rank-0-rooted, as the reference's mailbox collectives: the reduction
# order is fixed (ascending rank), so results are bitwise reproducible
# and equal the reference's.


_REDUCERS = {
    "sum": lambda a, b: a + b,
    "max": np.maximum,
    "min": np.minimum,
    "prod": lambda a, b: a * b,
}


def _env_rank_world(rank, world):
    """(rank, world): the default process group's, else the env's."""
    from .parallel import get_rank, get_world_size

    return (get_rank() if rank is None else int(rank),
            get_world_size() if world is None else int(world))


def _send(a, dst):
    import torch
    import torch.distributed as dist

    dist.send(torch.from_numpy(np.ascontiguousarray(a)), dst)


def _recv(like, src):
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.empty_like(like))
    dist.recv(t, src)
    return t.numpy()


def allreduce_host(arr, op="sum", *, rank=None, world=None,
                   deadline_s=None):
    """Deadline-guarded eager all-reduce of a host array across the gang
    (rank 0 receives in rank order, reduces, sends back; every rank
    passes the same shape and dtype). Raises CollectiveTimeoutError /
    PeerGoneError instead of blocking when a peer is gone."""
    rank, world = _env_rank_world(rank, world)
    remaining = deadline_guard("dist.allreduce", deadline_s)
    a = np.asarray(arr)
    if world <= 1:
        return a
    mean = op in ("mean", "avg")
    reduce_fn = _REDUCERS["sum" if mean else op]

    def _run():
        if rank == 0:
            out = a
            for src in range(1, world):
                out = reduce_fn(out, _recv(a, src))
            if mean:
                out = (out / np.asarray(world).astype(out.dtype)).astype(
                    out.dtype)
            out = np.asarray(out)
            for dst in range(1, world):
                _send(out, dst)
            return out
        _send(a, 0)
        return _recv(a, 0)

    return call_with_deadline(_run, remaining, "dist.allreduce")


def barrier_host(*, rank=None, world=None, deadline_s=None):
    """Deadline-guarded eager barrier (gather tokens at rank 0, then
    release). Every live rank either passes or raises a typed error
    within the deadline - no rank is left blocked."""
    rank, world = _env_rank_world(rank, world)
    remaining = deadline_guard("dist.barrier", deadline_s)
    if world <= 1:
        return
    token = np.zeros((), np.int32)

    def _run():
        if rank == 0:
            for src in range(1, world):
                _recv(token, src)
            for dst in range(1, world):
                _send(token, dst)
            return
        _send(token, 0)
        _recv(token, 0)

    call_with_deadline(_run, remaining, "dist.barrier")


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------


def _free_ports(n, host="127.0.0.1"):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind((host, 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def terminate_all(procs, grace=10.0):
    """Coordinated teardown: SIGTERM every live child, wait out one
    shared grace window, SIGKILL the stragglers, and REAP every exit so
    no zombie outlives the pod (launch._terminate_all delegates here)."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass
    # reap unconditionally: kill() without wait() leaves a zombie
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass


#: live supervisors, for the observe exporter's heartbeat-age gauges
_SUPERVISORS: "weakref.WeakSet[GangSupervisor]" = weakref.WeakSet()


def heartbeat_ages():
    """{slot: seconds since that rank's last heartbeat} across live
    supervisors (observe.export's paddle_gang_rank_heartbeat_age)."""
    out = {}
    for sup in list(_SUPERVISORS):
        for slot, rec in sup.rank_snapshot().items():
            if rec.get("beat_age_s") is not None:
                out[str(slot)] = rec["beat_age_s"]
    return out


class GangSupervisor:
    """Job-level supervisor for a gang of training ranks.

    What `serving/fleet.py` does for replicas, this does for the
    training gang — with the crucial difference that training ranks are
    NOT independent: any rank dying or stalling makes every peer's next
    collective undefined, so the only safe recovery is to tear down the
    whole gang and restart it from the newest globally committed
    checkpoint.

    - liveness: child process exit codes (the classic launch watchdog)
    - progress: per-rank heartbeat files + step watermarks written by
      `GangWorker.beat` into `gang_dir` — a rank that is alive but not
      advancing past FLAGS_gang_hang_secs is hung, not healthy
    - verdicts: an ElasticManager observer over the same registry turns
      membership changes (a new node beating in, a preempted rank
      deregistering) into coordinated RESTART re-formations within
      [min_np, max_np]
    - flaky ranks: a slot that causes `quarantine_after` teardowns is
      quarantined and the world re-forms without it (never below min_np)

    `cmd` is the training command (script + args); the supervisor
    appends the launch env contract per rank plus PADDLE_GANG_DIR /
    PADDLE_GANG_SLOT / PADDLE_GANG_ATTEMPT.
    """

    def __init__(self, cmd, nranks, *, gang_dir, min_np=1, max_np=None,
                 max_restarts=None, hang_secs=None, grace_s=10.0,
                 poll_interval=0.25, quarantine_after=2, log_dir=None,
                 backoff_base_s=0.5, backoff_max_s=8.0,
                 endpoints_fn=None, base_env=None, stderr=None):
        from ..framework import flags as _flags

        self.cmd = list(cmd)
        self.nranks = int(nranks)
        self.gang_dir = os.path.abspath(gang_dir)
        os.makedirs(self.gang_dir, exist_ok=True)
        self.min_np = int(min_np)
        self.max_np = int(max_np) if max_np else None
        if self.min_np > self.nranks:
            raise ValueError(
                f"min_np={self.min_np} exceeds nranks={self.nranks}: "
                "the gang could never form")
        self.max_restarts = (
            _flags.flag("FLAGS_gang_max_restarts")
            if max_restarts is None else int(max_restarts))
        self.hang_secs = (
            _flags.flag("FLAGS_gang_hang_secs")
            if hang_secs is None else float(hang_secs))
        self.grace_s = grace_s
        self.poll_interval = poll_interval
        self.quarantine_after = int(quarantine_after)
        self.log_dir = log_dir
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.endpoints_fn = endpoints_fn
        self.base_env = dict(base_env) if base_env is not None else None
        self.stderr = stderr if stderr is not None else sys.stderr

        self.restarts = 0
        self.generation = 0
        self.quarantined: set[int] = set()
        self._fault_counts: dict[int, int] = {}
        self._procs: dict[int, subprocess.Popen] = {}   # slot -> proc
        self._logs: list = []
        self._spawn_ts = 0.0
        self._watermarks: dict[int, tuple] = {}  # slot -> (step, ts)
        self._em = None
        self._formed = False
        _SUPERVISORS.add(self)

    # -- world formation ----------------------------------------------------

    def active_slots(self):
        """Slots forming the next world: original rank ids minus the
        quarantined, truncated to max_np (stable order, so rank i of
        the new world is the i-th surviving slot)."""
        slots = [s for s in range(self.nranks) if s not in self.quarantined]
        if self.max_np:
            slots = slots[: self.max_np]
        return slots

    def world_size(self):
        return len(self.active_slots())

    def _beat_path(self, slot):
        return os.path.join(self.gang_dir, f"rank-{slot}.beat")

    def _read_beat(self, slot):
        import json

        try:
            with open(self._beat_path(slot)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def rank_snapshot(self):
        """{slot: {alive, beat_age_s, step}} for export/telemetry."""
        now = time.time()
        out = {}
        for slot, p in self._procs.items():
            rec = self._read_beat(slot) or {}
            ts = rec.get("ts", 0)
            out[slot] = {
                "alive": p.poll() is None,
                "beat_age_s": (now - ts) if ts >= self._spawn_ts else None,
                "step": rec.get("step"),
            }
        return out

    def snapshot(self):
        return {
            "generation": self.generation,
            "restarts": self.restarts,
            "world": self.world_size(),
            "quarantined": sorted(self.quarantined),
            "ranks": {str(s): r for s, r in self.rank_snapshot().items()},
        }

    # -- spawn / teardown ---------------------------------------------------

    def _spawn_all(self):
        slots = self.active_slots()
        world = len(slots)
        if world < self.min_np:
            raise UnavailableError(
                f"cannot form a gang: {world} usable ranks < "
                f"min_np={self.min_np} (quarantined: "
                f"{sorted(self.quarantined)})")
        if self.endpoints_fn is not None:
            endpoints = self.endpoints_fn(world)
        else:
            endpoints = ["127.0.0.1:%d" % p for p in _free_ports(world)]
        base = self.base_env if self.base_env is not None \
            else dict(os.environ)
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        self.generation += 1
        self._spawn_ts = time.time()
        self._watermarks = {}
        self._formed = False
        procs, logs = {}, []
        for rank, slot in enumerate(slots):
            env = dict(base)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_MASTER": endpoints[0],
                "PADDLE_LOCAL_RANK": str(rank),
                "PADDLE_GANG_DIR": self.gang_dir,
                "PADDLE_GANG_SLOT": str(slot),
                "PADDLE_GANG_ATTEMPT": str(self.generation),
            })
            if self.log_dir:
                f = open(os.path.join(self.log_dir, f"workerlog.{slot}"),
                         "a" if self.generation > 1 else "w")
                logs.append(f)
                p = subprocess.Popen(self.cmd, env=env, stdout=f,
                                     stderr=subprocess.STDOUT)
            else:
                p = subprocess.Popen(self.cmd, env=env)
            procs[slot] = p
        self._procs, self._logs = procs, logs
        # fresh elastic observer per generation: the restart itself is a
        # membership change the verdict machinery must not re-trigger on
        from .elastic import ElasticManager

        self._em = ElasticManager(
            self.gang_dir, node_id="__supervisor__",
            min_np=self.min_np, max_np=self.max_np,
            timeout=max(self.hang_secs, 5.0) if self.hang_secs else 10.0)

    def terminate(self):
        terminate_all(list(self._procs.values()), grace=self.grace_s)
        for f in self._logs:
            try:
                f.close()
            except OSError:
                pass
        self._logs = []

    # -- fault detection ----------------------------------------------------

    def _check_exits(self):
        """(done, cause): done=True when every rank exited 0; cause set
        when any rank died non-zero."""
        all_done = True
        for slot, p in self._procs.items():
            ret = p.poll()
            if ret is None:
                all_done = False
            elif ret != 0:
                return False, ("exit", slot, ret)
        return all_done, None

    def _check_stalls(self):
        """Hang detection from the registry: a live rank whose heartbeat
        (or step watermark) last advanced more than hang_secs ago is
        hung — process liveness alone is not progress."""
        if not self.hang_secs:
            return None
        now = time.time()
        worst = None   # (age, slot)
        for slot, p in self._procs.items():
            if p.poll() is not None:
                continue
            rec = self._read_beat(slot)
            if rec is None or rec.get("ts", 0) < self._spawn_ts:
                continue   # never beat this generation: still booting
            step = rec.get("step")
            last_step, last_change = self._watermarks.get(
                slot, (None, rec["ts"]))
            if step != last_step:
                self._watermarks[slot] = (step, now)
                last_change = now
            age = now - max(rec["ts"], 0)
            stalled_beat = age > self.hang_secs
            stalled_step = (step is not None
                            and now - last_change > self.hang_secs)
            if stalled_beat or stalled_step:
                stall_age = max(age, now - last_change)
                if worst is None or stall_age > worst[0]:
                    worst = (stall_age, slot)
        if worst is not None:
            return ("stall", worst[1], worst[0])
        return None

    def _check_membership(self):
        """One ElasticManager verdict poll; RESTART = membership changed
        (a node joined/deregistered) -> coordinated re-formation.

        Two guards keep the verdict honest: (1) ranks registering one by
        one during gang FORMATION is not a membership change — verdicts
        only count once every expected rank has beaten; (2) a dead child
        is the exit-check's fault to attribute (with its exit code), not
        a membership event."""
        from .elastic import ElasticStatus

        if self._em is None:
            return None
        if any(p.poll() is not None for p in self._procs.values()):
            return None
        if not self._formed:
            live = self._em.live_nodes()
            if len(live) >= len(self._procs):
                self._formed = True
                self._em._known = sorted(live)  # the formed membership
            return None
        status = self._em.watch()
        if status == ElasticStatus.RESTART:
            return ("membership",)
        if status == ElasticStatus.EXIT:
            return ("preempted",)
        return None

    # -- restart ------------------------------------------------------------

    def _note_fault(self, slot, why):
        self._fault_counts[slot] = self._fault_counts.get(slot, 0) + 1
        if (self._fault_counts[slot] >= self.quarantine_after
                and len(self.active_slots()) - 1 >= self.min_np
                and slot not in self.quarantined):
            self.quarantined.add(slot)
            _monitor.stat_add("gang.quarantined")
            try:
                os.remove(self._beat_path(slot))
            except OSError:
                pass
            self.stderr.write(
                f"[launch] rank slot {slot} quarantined after "
                f"{self._fault_counts[slot]} faults ({why}); re-forming "
                f"the world with {len(self.active_slots())} ranks\n")

    def _restart(self, cause):
        """Coordinated teardown + re-formation. Returns None to keep
        supervising, or the job's final exit code to give up."""
        from ..framework import faults as _faults
        from .. import observe as _observe

        detect_ts = time.monotonic()
        kind = cause[0]
        code = cause[2] if kind == "exit" else 1
        if kind == "exit":
            slot = cause[1]
            self.stderr.write(
                f"[launch] rank {slot} (pid {self._procs[slot].pid}) "
                f"exited with code {code}; terminating the pod\n")
            self._note_fault(slot, f"exit code {code}")
        elif kind == "stall":
            slot, age = cause[1], cause[2]
            code = 1
            self.stderr.write(
                f"[launch] rank {slot} stalled ({age:.1f}s without "
                f"heartbeat/step progress > {self.hang_secs}s); "
                "terminating the pod\n")
            self._note_fault(slot, f"stalled {age:.1f}s")
        elif kind == "membership":
            self.stderr.write(
                "[launch] gang membership changed; re-forming the "
                "world\n")
        with _observe.phase("gang-restart", cat="gang"):
            self.terminate()
            if self.restarts >= self.max_restarts:
                self.stderr.write(
                    f"[launch] gang restart budget exhausted "
                    f"({self.restarts}/{self.max_restarts}); failing "
                    f"with code {code}\n")
                return code
            self.restarts += 1
            _monitor.stat_add("gang.restarts")
            reason = f"exit code {code}" if kind == "exit" else kind
            self.stderr.write(
                f"[launch] elastic restart {self.restarts}/"
                f"{self.max_restarts} after {reason}\n")
            _faults.fault_point("gang.restart")
            time.sleep(min(self.backoff_base_s * 2 ** (self.restarts - 1),
                           self.backoff_max_s))
            self._spawn_all()
        _monitor.stat_add("gang.restart_lost_ms",
                          int((time.monotonic() - detect_ts) * 1e3))
        return None

    # -- the supervised job -------------------------------------------------

    def run(self):
        """Supervise until the gang completes (0), the restart budget is
        spent (first failing exit code), or interrupt (130). A caller
        that already pre-spawned (launch's retrying bootstrap) is not
        double-spawned."""
        if not self._procs:
            self._spawn_all()
        try:
            while True:
                done, cause = self._check_exits()
                if done:
                    return 0
                cause = cause or self._check_stalls() \
                    or self._check_membership()
                if cause == ("preempted",):
                    self.terminate()
                    return 143
                if cause is not None:
                    code = self._restart(cause)
                    if code is not None:
                        return code
                    continue
                time.sleep(self.poll_interval)
        except KeyboardInterrupt:
            self.terminate()
            return 130
