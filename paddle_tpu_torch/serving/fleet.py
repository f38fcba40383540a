"""Resilient serving fleet: replica supervision, failover, retry/hedge
(counterpart of paddle_tpu/serving/fleet.py, same names and semantics).

A `ReplicaSet` supervises N thread-backed `SlotEngine` replicas on one
device (shared model weights, private KV pools, queues and int8 copies)
with step-heartbeat liveness watchdogs, and a `Router` fronts them with
the full availability toolkit. Every replica engine is built on the
set's explicit ``device``; its thread launches on that device's current
stream, so the replicas of one card interleave their steps on one
stream.

- **Failover replay.** A replica that crashes or stops heartbeating is
  declared dead, evicted, and rebuilt with exponential backoff +
  deterministic jitter. Its in-flight requests are replayed *from the
  original prompt* on a healthy replica. The client future is
  first-wins (queueing.Request), so even if the "dead" replica was
  merely hung and later completes, exactly one outcome is delivered —
  dedup is on the client request id; greedy replay gives the tokens of
  an uninterrupted run because decode is deterministic in the weights
  (on a card, up to near-ties: the replay runs in another batch, where
  cuBLAS may sum the body's matmuls in another order).
- **Retries.** Retriable failures (`CapacityExhaustedError`, injected
  `FaultError`, transient routing errors) are retried under a
  per-request retry budget with deadline propagation: each attempt's
  timeout is the *remaining* client deadline, never a fresh one.
  Failover replays charge a separate replay budget, not the retry
  budget — a replica dying is the fleet's fault, not the request's.
- **Hedging.** A request whose single attempt outlives a p95-based
  delay (2x observed e2e p95, floored at `hedge_min_s`; or a fixed
  `hedge_after_s`) gets a second attempt on a *different* replica.
  First completion wins, the loser is cancelled (its slot is
  reclaimed at the next step boundary), and the late outcome is
  suppressed by the first-wins future.
- **Graceful degradation.** Per-replica circuit breakers open after
  `breaker_threshold` consecutive failures, park the replica for
  `breaker_cooloff_s`, then admit a single half-open probe whose
  outcome closes or re-opens the breaker. Brownout mode — entered on
  sustained load above `brownout_high` (fraction of total slot+queue
  capacity), exited below `brownout_low`, or forced via
  `set_brownout()` — clamps `max_new_tokens` and sheds requests whose
  `priority` is below the floor with the retriable 429
  `BrownoutShedError`.

- **Elastic membership.** `ReplicaSet.add_replica()` grows the fleet
  under load: the new replica is visible in `starting` state (never
  routed to) while its engine builds behind the same restart path
  every rebuild uses (warmed up: its first step builds and launches
  the head kernel), then turns healthy.
  `remove_replica(name, drain=True)` shrinks it as drain-then-evict:
  the victim turns `draining` (the Router stops picking it
  immediately), finishes its in-flight and queued requests, and is
  evicted by the watchdog once idle — so a scale-down loses and
  duplicates nothing, certified by the same first-wins futures that
  cover failover. A draining replica that dies mid-drain takes the
  normal failover-replay path and is then dropped instead of
  restarted. `serving/autoscale.py` drives both ends from the SLO
  error budget.

- **Disaggregated prefill/decode** (``FLAGS_serving_disagg`` or
  ``Router(disagg=True)``). Replicas carry a `role` ("prefill" /
  "decode" / "any", assigned via ``roles=`` and specialized via
  ``role_kw=`` engine overrides — typically a wide ``prefill_chunk``
  for prefill replicas, a narrow one for decode). Each new request's
  first leg goes to a prefill-role replica with ``max_new_tokens=1``
  (the produced token is discarded); on success a migration thread
  streams the finished KV blocks to a decode replica over the
  deadline-guarded mailbox (serving/migrate.py), then the decode leg
  dispatches with one-shot affinity to the adopting replica and a pin
  to the prefill leg's weight version — a wave can never mix weight
  versions within one request. Any failure (no roles healthy,
  migration fault/timeout, adoption abort) degrades the request to
  ordinary colocated dispatch; failover replay and first-wins dedup
  apply to both legs unchanged. Prefill legs are never hedged.

- **Prefix-cache-aware routing** (``FLAGS_serving_prefix_affinity``,
  on by default). Every submit computes the same cumulative sha1
  block-boundary digests the radix `PrefixCache` indexes on and
  consults a sticky digest -> replica table, steering the request to
  the replica holding the longest live match for its token prefix —
  multi-turn sessions keep landing where their KV already is, so turn
  N pays decode-only latency instead of a full re-prefill. This
  generalizes the one-shot adopted-KV ``prefer`` affinity into
  sticky-with-failover: when the affine replica is dead, draining,
  breaker-open, excluded, or version-mismatched, dispatch falls
  through to the normal least-loaded pick, and the table re-sticks to
  wherever the request actually lands (the new replica re-prefills —
  or restores from the SSD spill tier, serving/kvstore.py — and
  becomes the session's new home). The ``serving.affinity`` fault
  site fires per affinity decision; an injected raise degrades that
  one decision to least-loaded placement. Per-replica affinity hits
  and engine-local prefix hit rates export via
  ``snapshot()["affinity"]``.

Chaos sites (framework/faults.py): ``serving.replica_step`` and
``serving.replica_heartbeat`` fire inside supervised engine loops
(tagged with the replica name, so ``serving.replica_step[fleet.r0]``
hangs exactly one replica), ``serving.route`` on every Router dispatch,
``serving.replay`` on every failover replay, ``serving.scale_up`` /
``serving.scale_down`` on every membership change and ``serving.drain``
on every drained-victim eviction attempt (all three tagged with the
replica name). `faults.ChaosSchedule` certifies a scripted sweep
actually delivered every planned fire.

`ReplicaSet.compile_counts()` / `Router.compile_counts()` give each
replica's engine counters (`SlotEngine.compile_counts`): the fleet's
compile invariant is every engine at one decode + one cow compile. The
per-replica state, restart, heartbeat and breaker gauges are
`observe.prometheus_text(fleet=router.snapshot())`'s. Waiting in this
port: mesh-sharded replicas.

Threading/locking: one re-entrant Router lock guards flight state;
engine done-callbacks run on engine threads and re-enter the Router
through it. The ReplicaSet's own lock covers only replica state
transitions and is never held across Router calls; queue condition
locks never run callbacks (queueing.py resolves futures outside its
locks) — so the lock order Router -> queue is acyclic.
"""

from __future__ import annotations

import random
import threading
import time

from .. import resolve_device
from ..framework import faults, monitor
from ..framework.flags import flag
from .engine import SlotEngine
from .metrics import ServingMetrics
from .paging import PrefixCache
from .queueing import (
    AdmissionQueue, BrownoutShedError, DeadlineExceededError, Request,
    RequestCancelled, ReplicaDiedError, RetriesExhaustedError, ServerClosedError,
    ServingError, TenantBudgetError, TenantFairQueue, VersionRetiredError,
)

__all__ = ["CircuitBreaker", "Replica", "ReplicaSet", "Router", "retriable",
           "REPLICA_STATE_CODES"]

#: numeric encodings for the per-replica state gauge; "healthy" is the
#: serving state, "draining" a scale-down victim
#: finishing its in-flight work before eviction
REPLICA_STATE_CODES = {"starting": 0, "healthy": 1, "dead": 2,
                       "backoff": 3, "stopped": 4, "draining": 5}


def retriable(error):
    """May the fleet transparently re-run the same request after this
    failure? Client-caused outcomes (cancel, deadline) never are;
    injected `FaultError`s model transient infrastructure errors and
    are; everything else consults the error's own `retriable` attr
    (see queueing.ServingError)."""
    if isinstance(error, (RequestCancelled, DeadlineExceededError)):
        return False
    if isinstance(error, TenantBudgetError):
        # the token bucket is the TENANT's, shared by every replica —
        # a retry elsewhere re-debits the same bucket and still fails;
        # surface the 429 + Retry-After to the client instead
        return False
    if isinstance(error, faults.FaultError):
        return True
    return bool(getattr(error, "retriable", False))


class CircuitBreaker:
    """Per-replica failure gate: closed -> open after `threshold`
    consecutive failures -> (after `cooloff_s`) half-open admitting one
    probe -> closed on probe success, re-open on probe failure.

    `clock` is injectable so unit tests drive the cooloff without
    sleeping. Thread-safe; `allow()` has the probe side effect (at most
    one caller wins the half-open slot per cooloff window).
    """

    def __init__(self, threshold=5, cooloff_s=1.0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooloff_s = cooloff_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0          # consecutive
        self._opened_at = None
        self._probing = False

    def allow(self):
        """May a request be routed here right now? In half-open state
        only the first caller gets True (the probe)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open" and \
                    self._clock() - self._opened_at >= self.cooloff_s:
                self.state = "half-open"
                self._probing = False
            if self.state == "half-open" and not self._probing:
                self._probing = True
                return True
            return False

    def probe_ready(self):
        """Would `allow()` grant a half-open probe? (No side effect.)"""
        with self._lock:
            if self.state == "open":
                return self._clock() - self._opened_at >= self.cooloff_s
            return self.state == "half-open" and not self._probing

    def record_success(self):
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self._probing = False

    def record_failure(self):
        with self._lock:
            self.failures += 1
            if self.state == "half-open" or self.failures >= self.threshold:
                self.state = "open"
                self._opened_at = self._clock()
                self._probing = False

    def snapshot(self):
        with self._lock:
            return {"state": self.state, "failures": self.failures}


class Replica:
    """One supervised engine slot: the engine itself (rebuilt across
    generations), liveness/restart bookkeeping, and its breaker.

    `role` is the disaggregation assignment: "any" (default) serves
    whole requests; "prefill" replicas only take the prefill leg of a
    disaggregated flight and stream their finished KV blocks out;
    "decode" replicas take everything except prefill legs. Roles are
    routing hints on the Router side — the engine itself is identical."""

    def __init__(self, index, name, breaker, role="any"):
        self.index = index
        self.name = name
        self.role = role
        self.engine: SlotEngine | None = None
        self.generation = 0       # bumped per (re)build
        self.state = "starting"   # REPLICA_STATE_CODES keys
        self.deaths = 0
        self.restarts = 0
        self.load = 0             # router-visible in-flight attempts
        self.breaker = breaker
        self.restart_at = None    # monotonic time the backoff expires
        self.built_at = None      # monotonic time the engine last built
        self.drain_started = None  # monotonic time draining began
        # rollout pinning: target_weights is the WeightVersion every
        # (re)build of this replica must load (None = the model's own
        # values, version 0); rebuild_to is set while the replica drains
        # toward an upgrade/downgrade and survives a mid-drain crash
        self.target_weights = None
        self.rebuild_to = None
        # deterministic per-replica jitter stream (seeded on the name)
        self._rng = random.Random(name)

    @property
    def alive(self):
        """Is the engine thread actually running?"""
        e = self.engine
        return (e is not None and e._thread is not None
                and e._thread.is_alive())

    def beat_age(self, now):
        e = self.engine
        return 0.0 if e is None else now - e.last_beat

    def uptime(self, now):
        return 0.0 if self.built_at is None else now - self.built_at

    def idle(self):
        """No router-visible attempts, no occupied slots, empty queue —
        the drain-complete condition for a scale-down victim."""
        e = self.engine
        return (self.load == 0 and e is not None
                and e.active == 0 and e.queue.depth == 0)

    @property
    def weight_version(self):
        """The weight version this replica serves (its live engine's)
        or — with no live engine — the one its next build targets."""
        if self.state in ("starting", "dead", "backoff"):
            wv = self.rebuild_to or self.target_weights
            if wv is not None:
                return wv.version
        if self.engine is not None:
            return self.engine.weight_version
        wv = self.rebuild_to or self.target_weights
        return wv.version if wv is not None else 0

    def snapshot(self):
        e = self.engine
        now = time.monotonic()
        return {
            "name": self.name, "state": self.state,
            "generation": self.generation, "deaths": self.deaths,
            "restarts": self.restarts, "load": self.load,
            "role": self.role,
            "weight_version": self.weight_version,
            "heartbeats": 0 if e is None else e.heartbeats,
            "uptime_s": self.uptime(now),
            "beat_age_s": self.beat_age(now),
            "draining_s": (0.0 if self.drain_started is None
                           else now - self.drain_started),
            "breaker": self.breaker.snapshot(),
        }


class ReplicaSet:
    """Supervises N thread-backed `SlotEngine` replicas over one model
    on one `device`.

    All replicas share the model weights (and the metrics registry) but
    own private KV pools, admission queues, int8 copies and module
    shells (`engine.module_shell`: each engine's `functional_call`
    swaps attributes of its own shell only, so replicas step at once).

    Builds are serialized on an internal lock (each build warms its
    engine up, which builds the head kernel on first use, and the
    rollout's golden chain takes the same lock), so serving continues
    on the built replicas during a sibling's rebuild.

    `poll()` is the watchdog: a healthy replica whose engine thread
    died is a *crash*; one whose heartbeat is older than
    `liveness_timeout_s` is a *hang*. Both are declared dead — the
    `on_death(replica, error)` hook (the Router's failover entry) runs
    first, then `engine.abandon(error)` fails everything still on the
    dead engine, then a rebuild is scheduled after
    ``backoff_base_s * 2^(deaths-1)`` (capped at `backoff_max_s`,
    scaled by deterministic per-replica jitter in [0.5, 1.5)).
    """

    def __init__(self, model, n_replicas=2, *, engine_kw=None, metrics=None,
                 liveness_timeout_s=2.0, backoff_base_s=0.05,
                 backoff_max_s=2.0, breaker_threshold=5,
                 breaker_cooloff_s=1.0, breaker_clock=time.monotonic,
                 queue_cap=None, warmup=True, name="fleet", on_death=None,
                 roles=None, role_kw=None, tenancy=None, device=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.model = model
        self.name = name
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.engine_kw = dict(engine_kw or {})
        # every replica engine is built on this one device (default
        # cuda; raises when asked for cuda with no GPU visible)
        self.device = resolve_device(
            device if device is not None else self.engine_kw.get("device"))
        self.engine_kw["device"] = self.device
        # disaggregation: roles[i] assigns the i-th initial replica
        # ("any"/"prefill"/"decode"; later additions default to "any");
        # role_kw maps a role to engine_kw overrides so e.g. decode
        # replicas run a narrow prefill_chunk while prefill replicas
        # run a wide one — the specialization the bench measures
        self.roles = list(roles or [])
        self.role_kw = dict(role_kw or {})
        self.queue_cap = queue_cap or flag("FLAGS_serving_queue_cap")
        # multi-tenant admission: with a TenantDirectory
        # attached, every replica builds a TenantFairQueue (weighted
        # fair queueing + per-tenant budgets) instead of the plain FIFO
        self.tenancy = tenancy
        self.liveness_timeout_s = liveness_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._breaker_kw = (breaker_threshold, breaker_cooloff_s,
                            breaker_clock)
        self._warmup = warmup
        self.on_death = on_death
        # committed WeightVersion newcomers build with (None = the
        # model's own values, version 0); RolloutController.commit sets
        # it via retarget() so scale-ups never resurrect an old version
        self.default_weights = None
        self.replicas = [self._new_replica() for _ in range(n_replicas)]
        # chip-time ledger (chip-hours = replica-seconds / 3600): time
        # already banked by evicted/removed engines; live engines add
        # their current uptime in replica_seconds()
        self._banked_replica_s = 0.0
        self._lock = threading.Lock()       # replica state transitions
        self._build_lock = threading.Lock()  # serialize builds
        self._started = False

    def _new_replica(self):
        """Allocate the next replica slot (monotonic index: names never
        recycle across scale-downs, so per-replica tagged fault specs
        and metrics labels stay unambiguous)."""
        i = self._next_index = getattr(self, "_next_index", -1) + 1
        threshold, cooloff_s, clock = self._breaker_kw
        role = self.roles[i] if i < len(self.roles) else "any"
        return Replica(i, f"{self.name}.r{i}",
                       CircuitBreaker(threshold, cooloff_s, clock=clock),
                       role=role)

    def start(self):
        if self._started:
            return self
        for r in self.replicas:
            self._build(r)
        self._started = True
        return self

    def _build(self, replica):
        """(Re)build one replica: fresh queue, fresh engine, warmed up
        (the head kernel launches once). The replica turns healthy only
        once serving."""
        with self._build_lock:
            wv = replica.rebuild_to or replica.target_weights \
                or self.default_weights
            if wv is not None:
                replica.target_weights = wv
                replica.rebuild_to = None
            if self.tenancy is not None:
                q = TenantFairQueue(self.queue_cap,
                                    tenancy=self.tenancy,
                                    metrics=self.metrics)
            else:
                q = AdmissionQueue(self.queue_cap, metrics=self.metrics)
            kw = dict(self.engine_kw)
            kw.update(self.role_kw.get(replica.role, {}))
            eng = SlotEngine(self.model, metrics=self.metrics, queue=q,
                             name=replica.name, supervised=True,
                             values=None if wv is None else wv.values,
                             weight_version=0 if wv is None else wv.version,
                             **kw)
            if self._warmup:
                eng.warmup()
            eng.start()
            replica.engine = eng
            replica.generation += 1
            replica.built_at = time.monotonic()
            replica.state = "healthy"
            replica.restart_at = None

    def healthy(self):
        return [r for r in self.replicas if r.state == "healthy"]

    def live_replicas(self):
        """Replicas currently able to serve traffic (healthy; draining
        ones still *hold* work but take no new routes)."""
        return len(self.healthy())

    def member_replicas(self):
        """Fleet membership the autoscaler sizes against: every replica
        that is serving or will serve again (starting/backoff/dead are
        on their way back; draining/stopped are on their way out)."""
        return sum(1 for r in self.replicas
                   if r.state in ("starting", "healthy", "dead", "backoff"))

    def poll(self, now=None):
        """One watchdog pass: detect crashes/hangs, run due restarts,
        evict scale-down victims that finished draining."""
        now = time.monotonic() if now is None else now
        for r in self.replicas:
            if r.state == "healthy":
                if not r.alive:
                    self.declare_dead(r, "engine thread died")
                elif r.beat_age(now) > self.liveness_timeout_s:
                    self.declare_dead(
                        r, f"no heartbeat for {r.beat_age(now):.2f}s "
                           f"(liveness timeout {self.liveness_timeout_s}s)")
            elif r.state == "backoff" and now >= (r.restart_at or 0):
                self.restart(r)
            elif r.state == "draining":
                if not r.alive or r.beat_age(now) > self.liveness_timeout_s:
                    # a victim dying mid-drain takes the normal failover
                    # path (its in-flight work replays) and is dropped —
                    # unless it was draining toward a rebuild, in which
                    # case declare_dead keeps it pinned to its target
                    self.declare_dead(r, "died while draining")
                elif r.idle():
                    if r.rebuild_to is not None:
                        self._start_rebuild(r)
                    else:
                        self._finish_drain(r)

    def declare_dead(self, replica, reason):
        """Evict one replica: failover hook first (the Router replays
        its in-flight requests while their old attempts are still
        pending — first-wins futures make the race safe), then abandon
        the engine, then schedule the backed-off rebuild — or, for a
        scale-down victim that died mid-drain, drop it for good."""
        with self._lock:
            if replica.state not in ("healthy", "draining"):
                return False
            was_draining = replica.state == "draining"
            replica.state = "dead"
            replica.deaths += 1
            self._bank_uptime(replica)
        self.metrics.inc("replica_deaths")
        err = ReplicaDiedError(f"replica {replica.name} declared dead: "
                               f"{reason}")
        if self.on_death is not None:
            try:
                self.on_death(replica, err)
            except Exception:  # noqa: BLE001 — watchdog must survive
                self.metrics.inc("supervisor_errors")
        old = replica.engine
        if old is not None:
            old.abandon(err)
        if was_draining:
            if replica.rebuild_to is None:
                self._drop(replica)   # it was leaving anyway: no restart
                return True
            # died mid drain->rebuild: NOT a scale-down victim — keep
            # it, pin the restart to the version the rollout assigned
            # (a mid-wave crash must not drift the fleet's version map)
            with self._lock:
                replica.target_weights = replica.rebuild_to
                replica.rebuild_to = None
        with self._lock:
            backoff = min(self.backoff_base_s * (2 ** (replica.deaths - 1)),
                          self.backoff_max_s)
            backoff *= 0.5 + replica._rng.random()
            replica.restart_at = time.monotonic() + backoff
            replica.state = "backoff"
        return True

    def restart(self, replica):
        self._build(replica)
        replica.restarts += 1
        self.metrics.inc("replica_restarts")
        # a rebuilt replica starts with a clean slate
        replica.breaker.record_success()

    def kill(self, name, reason="killed (admin/chaos)"):
        """Admin/chaos hook: declare one replica dead right now, ahead
        of the watchdog. Returns the replica."""
        for r in self.replicas:
            if r.name == name:
                self.declare_dead(r, reason)
                return r
        raise KeyError(f"no replica named {name!r}")

    # -- elastic membership (scale events) ----------------------------------

    def add_replica(self):
        """Scale up by one replica. The newcomer is appended in
        `starting` state — visible to snapshots but never to the
        Router's `_pick` — then built behind the same restart path
        every rebuild uses (serialized on `_build_lock`, warmed up), and
        only then turns healthy. Blocking (the build warms up); run it
        off the supervisor thread.
        Fault site ``serving.scale_up`` fires before the build."""
        with self._lock:
            replica = self._new_replica()
            self.replicas = self.replicas + [replica]
        try:
            faults.fault_point("serving.scale_up", tag=replica.name)
            self._build(replica)
        except Exception:
            with self._lock:   # roll the membership change back
                replica.state = "stopped"
                self.replicas = [r for r in self.replicas
                                 if r is not replica]
            raise
        self.metrics.inc("replicas_added")
        monitor.stat_add("fleet.scale_events_up")
        return replica

    def remove_replica(self, name, drain=True):
        """Scale down by one replica: drain-then-evict. The victim
        turns `draining` immediately (the Router stops routing to it;
        its queued + in-flight requests keep running) and the watchdog
        evicts it once idle — zero requests lost, zero duplicated,
        certified by the first-wins future machinery. ``drain=False``
        evicts right now instead: in-flight requests take the failover
        replay path. Fault site ``serving.scale_down`` fires before the
        state flips. Returns the replica."""
        victim = None
        with self._lock:
            for r in self.replicas:
                if r.name == name:
                    victim = r
                    break
            if victim is None:
                raise KeyError(f"no replica named {name!r}")
            if victim.state not in ("healthy", "starting"):
                raise ValueError(
                    f"cannot remove replica {name!r} in state "
                    f"{victim.state!r}")
            if self.live_replicas() <= 1 and victim.state == "healthy":
                raise ValueError(
                    "cannot remove the last healthy replica")
        faults.fault_point("serving.scale_down", tag=victim.name)
        with self._lock:
            victim.state = "draining"
            victim.drain_started = time.monotonic()
        self.metrics.inc("drains_started")
        monitor.stat_add("fleet.scale_events_down")
        if not drain:
            self.declare_dead(victim, "evicted (non-drain scale-down)")
        return victim

    def _finish_drain(self, replica):
        """Evict one fully drained scale-down victim. The
        ``serving.drain`` fault site fires per eviction attempt: a
        `raise` leaves the replica draining (retried at the next poll),
        a `delay` models slow teardown."""
        try:
            faults.fault_point("serving.drain", tag=replica.name)
        except Exception:  # noqa: BLE001 — retry at the next poll
            self.metrics.inc("drain_errors")
            return False
        with self._lock:
            if replica.state != "draining":
                return False
            replica.state = "stopped"
            self._bank_uptime(replica)
        e = replica.engine
        if e is not None:
            try:
                e.shutdown(drain=True, timeout=5.0)
            except Exception:  # noqa: BLE001 — best-effort stop
                pass
        self._drop(replica)
        self.metrics.inc("replicas_removed")
        return True

    # -- rolling upgrades (serving.rollout) ----------------------------------

    def rebuild_replica(self, name, weights):
        """Rolling-upgrade entry: mark one healthy replica draining
        with a rebuild target. The Router stops routing to it, its
        in-flight requests FINISH ON THE OLD WEIGHTS (no mid-sequence
        version tear), and once idle the watchdog swaps in a fresh
        engine built on `weights` (a `rollout.WeightVersion`) behind
        the same `_build` path every restart uses."""
        with self._lock:
            victim = None
            for r in self.replicas:
                if r.name == name:
                    victim = r
                    break
            if victim is None:
                raise KeyError(f"no replica named {name!r}")
            if victim.state != "healthy":
                raise ValueError(
                    f"cannot rebuild replica {name!r} in state "
                    f"{victim.state!r}")
            victim.state = "draining"
            victim.drain_started = time.monotonic()
            victim.rebuild_to = weights
        self.metrics.inc("rollout_rebuilds")
        return victim

    def _start_rebuild(self, replica):
        """A drained upgrade victim: retire its old engine and build
        the replacement on the target weights, off the supervisor
        thread (the build warms up — blocking the watchdog would blind
        the rest of the fleet's liveness checks)."""
        with self._lock:
            wv = replica.rebuild_to
            if replica.state != "draining" or wv is None:
                return False
            replica.state = "starting"
            replica.target_weights = wv
            replica.rebuild_to = None
            self._bank_uptime(replica)
        old = replica.engine

        def _swap():
            if old is not None:
                try:
                    old.shutdown(drain=True, timeout=5.0)
                except Exception:  # noqa: BLE001 — best-effort stop
                    pass
            try:
                self._build(replica)
                replica.breaker.record_success()
                self.metrics.inc("rollout_rebuilds_done")
            except Exception:  # noqa: BLE001 — retry via backoff
                self.metrics.inc("supervisor_errors")
                with self._lock:
                    replica.deaths += 1
                    replica.restart_at = (time.monotonic()
                                          + self.backoff_base_s)
                    replica.state = "backoff"

        threading.Thread(target=_swap, name=f"{replica.name}-rollout",
                         daemon=True).start()
        return True

    def versions_live(self):
        """Every weight version some replica serves or will serve after
        its pending (re)build — the Router's pinned-replay oracle: a
        pin outside this set can never be satisfied again."""
        out = set()
        for r in self.replicas:
            if r.state == "stopped":
                continue
            out.add(r.weight_version)
            if r.rebuild_to is not None:
                out.add(r.rebuild_to.version)
        return out

    def retarget(self, weights):
        """Pin the whole membership (and every future member) to one
        WeightVersion: rollout commit/abort calls this so backoff
        restarts and scale-ups land on the surviving version, never on
        one the registry retired."""
        with self._lock:
            self.default_weights = weights
            for r in self.replicas:
                if r.state == "stopped":
                    continue
                r.target_weights = weights
                if r.rebuild_to is not None:
                    r.rebuild_to = weights

    def _drop(self, replica):
        """Remove one replica from the membership list (atomic list
        swap: concurrent iterations keep walking the old snapshot)."""
        with self._lock:
            replica.state = "stopped"
            self.replicas = [r for r in self.replicas if r is not replica]

    def _bank_uptime(self, replica):
        """Move a replica's current engine uptime into the chip-time
        ledger (caller holds `_lock`)."""
        if replica.built_at is not None:
            self._banked_replica_s += time.monotonic() - replica.built_at
            replica.built_at = None

    def replica_seconds(self, now=None):
        """Cumulative engine-alive seconds across the fleet's life —
        the card-hours denominator of a fleet benchmark (a replica
        costs its card whether busy or idle)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            live = sum(now - r.built_at for r in self.replicas
                       if r.built_at is not None)
            return self._banked_replica_s + live

    def compile_counts(self):
        """{replica name: engine compile counters} — the fleet compile
        invariant is every engine at one decode + one cow compile."""
        return {r.name: (r.engine.compile_counts if r.engine else {})
                for r in self.replicas}

    def queue_depth(self):
        return sum(r.engine.queue.depth for r in self.replicas
                   if r.state == "healthy" and r.engine is not None)

    def capacity(self):
        """Total (slots + queue) headroom across healthy replicas."""
        return sum(r.engine.max_slots + r.engine.queue.cap
                   for r in self.healthy() if r.engine is not None)

    def slot_capacity(self):
        """Decode slots across healthy replicas — how many requests the
        fleet can *run* right now, as opposed to merely queue."""
        return sum(r.engine.max_slots
                   for r in self.healthy() if r.engine is not None)

    def in_flight(self):
        return sum(r.engine.active + r.engine.queue.depth
                   for r in self.healthy() if r.engine is not None)

    def snapshot(self):
        now = time.monotonic()
        return {"name": self.name,
                "live_replicas": self.live_replicas(),
                "member_replicas": self.member_replicas(),
                "replica_seconds": self.replica_seconds(now),
                "replicas": [r.snapshot() for r in self.replicas]}

    def shutdown(self, drain=True, timeout=None):
        for r in self.replicas:
            e = r.engine
            if e is not None:
                try:
                    e.shutdown(drain=drain, timeout=timeout)
                except Exception:  # noqa: BLE001 — best-effort stop
                    pass
            r.state = "stopped"
        self._started = False


class _Flight:
    """Router-side state of one client request across its attempts."""

    __slots__ = ("client", "retries_left", "replays_left", "attempts",
                 "live", "stale", "hedge_ids", "hedged", "parked",
                 "first_dispatch", "last_dispatch", "retry_at",
                 "retry_exclude", "versions", "pin", "prefill_ids",
                 "kv_state", "prefer", "prefix_digests")

    def __init__(self, client, retries, replays):
        self.client = client
        self.retries_left = retries
        self.replays_left = replays
        self.attempts: dict = {}   # attempt id -> (replica, attempt req)
        self.live: set = set()     # attempt ids not yet resolved
        self.stale: set = set()    # live ids whose outcome is ignored
        self.hedge_ids: set = set()
        self.hedged = False
        self.parked = False        # no dispatchable replica right now
        self.first_dispatch = None
        self.last_dispatch = None
        self.retry_at = None       # deferred-retry due time
        self.retry_exclude = None
        self.versions: dict = {}   # attempt id -> engine weight version
        self.pin = None            # replay weight-version pin
        # disaggregated prefill/decode bookkeeping
        self.prefill_ids: set = set()  # attempt ids that are prefill legs
        self.kv_state = None       # None / "migrated" / "fallback"
        self.prefer = None         # one-shot replica affinity (adopted KV)
        # cumulative block-boundary prefix digests of the prompt,
        # ascending length — the sticky-affinity lookup keys (longest
        # match wins; empty = prompt shorter than one block)
        self.prefix_digests = ()

    def active(self):
        return [aid for aid in self.live if aid not in self.stale]


class Router:
    """Fleet front: routes client requests over a `ReplicaSet` with
    failover replay, budgeted retries, hedging, circuit breaking, and
    brownout shedding. See the module docstring for semantics.

    `submit()` mirrors `SlotEngine.submit` (plus `priority=`) and
    returns the same first-wins `Request` future, so `Server` and
    clients are agnostic to whether they talk to one engine or a fleet.
    """

    def __init__(self, model, replicas=2, *, engine_kw=None, metrics=None,
                 retry_budget=2, replay_budget=None, retry_backoff_s=0.0,
                 hedge=True, hedge_after_s=None, hedge_min_s=0.25,
                 liveness_timeout_s=2.0, tick_s=0.005,
                 brownout_high=0.95, brownout_low=0.5,
                 brownout_max_new=8, brownout_priority=1,
                 breaker_threshold=5, breaker_cooloff_s=1.0,
                 breaker_clock=time.monotonic,
                 backoff_base_s=0.05, backoff_max_s=2.0,
                 queue_cap=None, warmup=True, name="fleet",
                 autoscale=None, roles=None, role_kw=None, disagg=None,
                 migrate_deadline_s=5.0, prefix_affinity=None,
                 tenancy=None, device=None):
        from .migrate import KVMailbox

        self.metrics = metrics if metrics is not None else ServingMetrics()
        # multi-tenant mode: a TenantDirectory turns the
        # replica queues into weighted-fair TenantFairQueues and switches
        # brownout from a global priority floor to tier-based shedding
        self.tenancy = tenancy
        self.replica_set = ReplicaSet(
            model, replicas, engine_kw=engine_kw, metrics=self.metrics,
            liveness_timeout_s=liveness_timeout_s,
            backoff_base_s=backoff_base_s, backoff_max_s=backoff_max_s,
            breaker_threshold=breaker_threshold,
            breaker_cooloff_s=breaker_cooloff_s,
            breaker_clock=breaker_clock, queue_cap=queue_cap,
            warmup=warmup, name=name, on_death=self._on_replica_death,
            roles=roles, role_kw=role_kw, tenancy=tenancy, device=device)
        self.name = name
        # disaggregated prefill/decode: the Router sends each
        # request's prefill to a prefill-role replica, migrates the
        # finished KV blocks over the deadline-guarded mailbox, then
        # dispatches the decode leg (pinned to the prefill leg's weight
        # version) with affinity to the adopting replica. Degrades to
        # colocated dispatch whenever roles or migration are unavailable.
        self._disagg = bool(flag("FLAGS_serving_disagg")) \
            if disagg is None else bool(disagg)
        self._kv_mailbox = KVMailbox()
        self._migrate_deadline_s = migrate_deadline_s
        # prefix-cache-aware routing: sticky map from a
        # cumulative prompt-prefix digest (PrefixCache._digest at block
        # boundaries) to the name of the replica that last served a
        # request with that prefix. Longest-match lookup in _dispatch;
        # re-stuck on every placement, so failover moves the session's
        # home instead of pinning it to a corpse. Size-capped FIFO.
        self._affinity_on = None if prefix_affinity is None \
            else bool(prefix_affinity)
        self._affinity: dict = {}          # digest -> replica name
        self._affinity_cap = 4096
        self._affinity_lookups = 0
        self._affinity_hits: dict = {}     # replica name -> hits
        self._block_size = None
        self.retry_budget = retry_budget
        self.replay_budget = replay_budget if replay_budget is not None \
            else max(replicas, 2)
        self.retry_backoff_s = retry_backoff_s
        self._hedge_enabled = hedge and replicas > 1
        self._hedge_after_s = hedge_after_s
        self._hedge_min_s = hedge_min_s
        self._tick_s = tick_s
        self._brownout_high = brownout_high
        self._brownout_low = brownout_low
        self._brownout_max_new = brownout_max_new
        self._brownout_priority = brownout_priority
        self._lock = threading.RLock()
        self._flights: dict = {}        # client req id -> _Flight
        self._attempt_index: dict = {}  # attempt req id -> _Flight
        self._brownout = False
        self._brownout_force = None     # None = auto hysteresis
        self._stop = threading.Event()
        self._sup = None
        self._max_seq_len = None
        # autoscale=None/False: fixed fleet. autoscale=True: defaults
        # (flags). autoscale=dict: Autoscaler kwargs. Built in start()
        # so tests can also attach one by hand before starting.
        self._autoscale_spec = autoscale
        self.autoscaler = None
        # RolloutController attaches itself here (rollout.py), the same
        # way the Autoscaler does; /v1/version reads through it
        self.rollout = None

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._sup is not None:
            return self
        self.replica_set.start()
        eng0 = self.replica_set.replicas[0].engine
        self._max_seq_len = eng0.max_seq_len
        self._block_size = eng0.block_size
        if self._affinity_on is None:
            self._affinity_on = bool(flag("FLAGS_serving_prefix_affinity"))
        if self._autoscale_spec and self.autoscaler is None:
            from .autoscale import Autoscaler
            kw = (dict(self._autoscale_spec)
                  if isinstance(self._autoscale_spec, dict) else {})
            self.autoscaler = Autoscaler(self, **kw)
        self._stop.clear()
        self._sup = threading.Thread(target=self._supervise,
                                     name=f"{self.name}-supervisor",
                                     daemon=True)
        self._sup.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the fleet. drain=True waits for in-flight flights to
        settle (bounded by `timeout`, default 30s) before stopping the
        supervisor and engines; drain=False fails every open flight."""
        if drain:
            deadline = time.monotonic() + (30.0 if timeout is None
                                           else timeout)
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._flights:
                        break
                time.sleep(0.005)
        if self.autoscaler is not None:
            self.autoscaler.close()
        self._stop.set()
        if self._sup is not None:
            self._sup.join(timeout)
            self._sup = None
        if not drain:
            with self._lock:
                for flight in list(self._flights.values()):
                    self._finish_fail(flight, ServerClosedError(
                        f"request {flight.client.id} aborted: "
                        "fleet shutdown"))
        self.replica_set.shutdown(drain=drain, timeout=timeout)

    # -- client API ---------------------------------------------------------

    def submit(self, prompt_ids, *, max_new_tokens=16, eos_token_id=None,
               timeout=None, priority=0, do_sample=False, temperature=1.0,
               top_k=0, seed=0, adapter_id=0, tenant=None):
        """Route one request; returns its first-wins `Request` future.

        Client errors (empty/over-long prompt) raise synchronously;
        brownout sheds below-floor priorities with `BrownoutShedError`
        (429, retriable) — or, when a `TenantDirectory` is attached,
        below-tier tenants. Everything downstream — replica choice,
        retries, failover, hedging — is the Router's problem."""
        import numpy as np

        if self._sup is None:
            self.start()
        if timeout is None:
            timeout = flag("FLAGS_serving_default_timeout_s") or None
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if ids.size + max_new_tokens > self._max_seq_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds fleet max_seq_len {self._max_seq_len}")
        if self.tenancy is not None:
            spec = self.tenancy.resolve(tenant)
            tenant = spec.name
            if priority == 0:
                priority = spec.priority
            if self.brownout_active and spec.tier < self.tenancy.brownout_tier:
                self.metrics.inc("brownout_sheds")
                if hasattr(self.metrics, "tenant_inc"):
                    self.metrics.tenant_inc(spec.name, "shed")
                raise BrownoutShedError(
                    f"request shed: fleet in brownout, tenant "
                    f"{spec.name!r} tier {spec.tier} below floor "
                    f"{self.tenancy.brownout_tier}")
        elif self.brownout_active and priority < self._brownout_priority:
            self.metrics.inc("brownout_sheds")
            raise BrownoutShedError(
                f"request shed: fleet in brownout, priority {priority} "
                f"below floor {self._brownout_priority}")
        client = Request(ids, timeout=timeout, priority=priority,
                         max_new_tokens=max_new_tokens,
                         eos_token_id=eos_token_id, do_sample=do_sample,
                         temperature=temperature, top_k=top_k, seed=seed,
                         adapter_id=adapter_id, tenant=tenant)
        self.metrics.inc("fleet_submitted")
        flight = _Flight(client, self.retry_budget, self.replay_budget)
        if self._affinity_on and self._block_size:
            # the same cumulative block-boundary digests the replicas'
            # radix caches index on — ascending length, so a reversed
            # walk finds the longest sticky match first
            bs = self._block_size
            flight.prefix_digests = tuple(
                PrefixCache._digest(ids[:k * bs])
                for k in range(1, ids.size // bs + 1))
        with self._lock:
            self._flights[client.id] = flight
            # single cleanup point: whatever resolves the client —
            # success, typed failure, or client-side cancel — cancels
            # every attempt still pending and drops the flight
            client.add_done_callback(self._client_done_cb)
            self._dispatch(flight)
        return client

    def generate(self, prompt_ids, timeout=None, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt_ids, **kw).result(timeout)

    # -- introspection ------------------------------------------------------

    @property
    def brownout_active(self):
        if self._brownout_force is not None:
            return self._brownout_force
        return self._brownout

    def set_brownout(self, on):
        """Force brownout on/off, or None to return to automatic
        load-fraction hysteresis."""
        self._brownout_force = on

    @property
    def queue_depth(self):
        return self.replica_set.queue_depth()

    @property
    def in_flight(self):
        with self._lock:
            return len(self._flights)

    def compile_counts(self):
        return self.replica_set.compile_counts()

    def kill(self, name, reason="killed (admin/chaos)"):
        return self.replica_set.kill(name, reason)

    def add_replica(self):
        return self.replica_set.add_replica()

    def remove_replica(self, name, drain=True):
        return self.replica_set.remove_replica(name, drain=drain)

    def snapshot(self):
        snap = self.replica_set.snapshot()
        snap["brownout"] = self.brownout_active
        with self._lock:
            snap["in_flight"] = len(self._flights)
            if self._affinity_on:
                hits = sum(self._affinity_hits.values())
                per = {}
                for r in self.replica_set.replicas:
                    e = r.engine
                    per[r.name] = {
                        "hits": self._affinity_hits.get(r.name, 0),
                        "prefix_hit_rate": (e.prefix_hit_rate()
                                            if e is not None else 0.0),
                    }
                snap["affinity"] = {
                    "lookups": self._affinity_lookups,
                    "hits": hits,
                    "hit_rate": (hits / self._affinity_lookups
                                 if self._affinity_lookups else 0.0),
                    "table_size": len(self._affinity),
                    "per_replica": per,
                }
        if self.autoscaler is not None:
            snap["autoscaler"] = self.autoscaler.snapshot()
        if self.rollout is not None:
            snap["rollout"] = self.rollout.snapshot()
        return snap

    def version_info(self):
        """Rollout-facing view (GET /v1/version): per-replica weight
        versions, the versions still live in the fleet, and — when a
        RolloutController is attached — registry current/previous plus
        the rollout state machine."""
        rs = self.replica_set
        per = {r.name: r.weight_version for r in rs.replicas
               if r.state != "stopped"}
        live = sorted(rs.versions_live())
        info = {"replicas": per, "versions_live": live,
                "state": "static", "target": None, "previous": None,
                "error": None, "current": max(live) if live else 0}
        ro = self.rollout
        if ro is not None:
            info.update(current=ro.registry.current,
                        previous=ro.registry.previous,
                        state=ro.state, target=ro.target, error=ro.error)
        return info

    # -- flight machinery ---------------------------------------------------

    def _dispatch(self, flight, exclude=frozenset(), hedge=False,
                  version=None):
        """Place one attempt. With `hedge` the exclusion is strict (no
        point hedging onto the replica already working the request);
        otherwise a lone excluded replica is better than parking.
        `version` (or the flight's replay pin) restricts placement to
        replicas serving that exact weight version — a replay or hedge
        must stay bitwise against its original attempt, never silently
        decode on different weights mid-rollout."""
        with self._lock:
            client = flight.client
            if client.done():
                return
            remaining = None
            if client.deadline is not None:
                remaining = client.deadline - time.monotonic()
                if remaining <= 0:
                    self._finish_fail(flight, DeadlineExceededError(
                        f"request {client.id} deadline exceeded before "
                        "dispatch"))
                    return
            try:
                if faults.fault_point("serving.route") is faults.DROP:
                    raise faults.FaultError(
                        "injected fault at serving.route (drop)")
            except Exception as e:  # noqa: BLE001 — routing failure
                self._route_failed(flight, e)
                return
            pin = version if version is not None else flight.pin
            prefill_leg = False
            replica = None
            if flight.prefer is not None:
                # one-shot affinity: the replica that adopted this
                # flight's migrated KV blocks serves its decode leg
                p, flight.prefer = flight.prefer, None
                if (p.state == "healthy" and p not in exclude
                        and p.breaker.state == "closed"
                        and p.engine is not None
                        and (pin is None
                             or p.engine.weight_version == pin)):
                    replica = p
            if replica is None and not hedge and not self._disagg_on():
                # sticky prefix affinity: the replica that last served
                # this token prefix holds its KV blocks live (or can
                # restore them from the spill tier) — decode-only TTFT
                # instead of a re-prefill. Any failure (injected
                # serving.affinity fault, dead/draining/breaker-open
                # replica, version mismatch) falls through to the
                # normal pick and the session re-sticks there. Under
                # live disaggregation the role split owns placement:
                # fresh requests must take the prefill->migrate leg
                # (the adopted-KV `prefer` handles decode affinity).
                replica = self._affinity_pick(flight, exclude, pin)
            if replica is None and not hedge and flight.kv_state is None \
                    and self._disagg_on():
                replica = self._pick(exclude, version=pin, role="prefill")
                prefill_leg = replica is not None
            if replica is None:
                replica = self._pick(exclude, version=pin)
            if replica is None:
                if hedge:
                    flight.hedged = False   # retry the hedge next tick
                    return
                if exclude:
                    replica = self._pick(frozenset(), version=pin)
                if replica is None:
                    if pin is not None and \
                            pin not in self.replica_set.versions_live():
                        # the pinned version is gone for good (rollout
                        # retired it): replaying on different weights
                        # would break bitwise semantics — fail retriable
                        self.metrics.inc("version_retired_failures")
                        self._finish_fail(flight, VersionRetiredError(
                            f"request {client.id} is pinned to weight "
                            f"version {pin}, which no replica serves or "
                            "targets any more (retired by rollout); "
                            "resubmit to decode on the current version"))
                        return
                    if not flight.active():
                        flight.parked = True
                        self.metrics.inc("parked")
                    return
            flight.parked = False
            gen = dict(client.gen)
            if prefill_leg:
                # the prefill leg only has to fill the KV cache and
                # donate its blocks; one produced token is the engine's
                # minimum request (its value is discarded — the decode
                # leg re-picks every output token itself)
                gen["max_new_tokens"] = 1
            if self.brownout_active:
                gen["max_new_tokens"] = min(
                    gen.get("max_new_tokens", 16), self._brownout_max_new)
            try:
                attempt = replica.engine.submit(
                    client.payload, timeout=remaining,
                    priority=client.priority, **gen)
            except ServingError as e:
                replica.breaker.record_failure()
                self._attempt_failed(flight, replica, e)
                return
            except Exception as e:  # noqa: BLE001 — client error
                self._finish_fail(flight, e)
                return
            flight.attempts[attempt.id] = (replica, attempt)
            flight.versions[attempt.id] = replica.engine.weight_version
            flight.live.add(attempt.id)
            if prefill_leg:
                flight.prefill_ids.add(attempt.id)
            else:
                # (re)stick the session's prefix chain to wherever it
                # actually landed — on failover this moves the home;
                # prefill legs don't stick (the decode leg will)
                self._affinity_stick(flight, replica)
            if hedge:
                flight.hedge_ids.add(attempt.id)
                self.metrics.inc("hedges")
            self._attempt_index[attempt.id] = flight
            replica.load += 1
            flight.last_dispatch = time.monotonic()
            if flight.first_dispatch is None:
                flight.first_dispatch = flight.last_dispatch
            self.metrics.inc("routed")
            attempt.add_done_callback(self._attempt_done_cb)

    def _affinity_pick(self, flight, exclude, pin):
        """The sticky-affinity replica for this flight's longest mapped
        prompt prefix, or None when affinity is off / no digest maps /
        the mapped replica cannot take the attempt (then the caller's
        least-loaded pick handles placement and re-sticks). The
        ``serving.affinity`` fault site fires once per decision; a
        raised fault degrades this one decision to least-loaded."""
        if not self._affinity_on or not flight.prefix_digests:
            return None
        self._affinity_lookups += 1
        try:
            faults.fault_point("serving.affinity")
        except Exception:  # noqa: BLE001 — degrade to least-loaded
            self.metrics.inc("affinity_faults")
            return None
        by_name = {r.name: r for r in self.replica_set.replicas}
        for digest in reversed(flight.prefix_digests):   # longest first
            name = self._affinity.get(digest)
            if name is None:
                continue
            p = by_name.get(name)
            if (p is not None and p.state == "healthy"
                    and p not in exclude
                    and p.breaker.state == "closed"
                    and p.engine is not None
                    and self._role_ok(p, None)
                    and (pin is None
                         or p.engine.weight_version == pin)):
                self._affinity_hits[name] = \
                    self._affinity_hits.get(name, 0) + 1
                self.metrics.inc("affinity_hits")
                return p
            return None   # mapped but unroutable: fail over cleanly
        return None

    def _affinity_stick(self, flight, replica):
        """Point every prefix digest of this flight at the replica it
        landed on (insertion-ordered FIFO cap keeps the table bounded;
        re-inserts refresh recency)."""
        if not self._affinity_on or not flight.prefix_digests:
            return
        for digest in flight.prefix_digests:
            self._affinity.pop(digest, None)
            self._affinity[digest] = replica.name
        while len(self._affinity) > self._affinity_cap:
            self._affinity.pop(next(iter(self._affinity)))

    def _role_ok(self, replica, role):
        """May `replica` take an attempt of this kind? role="prefill"
        wants a prefill-specialized replica; role=None is a whole or
        decode attempt, which prefill-specialized replicas never take
        while disaggregation is on (they'd pay the wide-chunk step for
        every decode token — the exact cost disaggregation removes)."""
        if role is not None:
            return replica.role == role
        return replica.role != "prefill" or not self._disagg

    def _disagg_on(self):
        """Disaggregate right now? Needs the flag AND both roles
        healthy — a fleet that lost all its prefill (or decode)
        replicas degrades to colocated dispatch instead of parking."""
        if not self._disagg:
            return False
        have_prefill = have_decode = False
        for r in self.replica_set.replicas:
            if r.state == "healthy":
                if r.role == "prefill":
                    have_prefill = True
                else:
                    have_decode = True
        return have_prefill and have_decode

    def _pick(self, exclude, version=None, role=None):
        """Deterministic replica choice: a breaker awaiting its
        half-open probe goes first (lowest index — otherwise an open
        breaker could starve forever behind healthy siblings), else the
        least-loaded replica with a closed breaker (ties to the lowest
        index). `version` restricts to replicas serving that exact
        weight version (pinned replays/hedges mid-rollout); `role`
        restricts by disaggregation role (see `_role_ok`)."""
        candidates = [r for r in self.replica_set.replicas
                      if r.state == "healthy" and r not in exclude
                      and self._role_ok(r, role)
                      and (version is None or (
                          r.engine is not None
                          and r.engine.weight_version == version))]
        for r in candidates:
            if r.breaker.state != "closed" and r.breaker.probe_ready() \
                    and r.breaker.allow():
                return r
        best = None
        for r in candidates:
            if r.breaker.state != "closed":
                continue
            if best is None or (r.load, r.index) < (best.load, best.index):
                best = r
        return best

    def _route_failed(self, flight, err):
        if flight.retries_left > 0:
            flight.retries_left -= 1
            self.metrics.inc("retries")
            self._defer(flight, frozenset())
            return
        self.metrics.inc("retry_budget_exhausted")
        self._finish_fail(flight, RetriesExhaustedError(
            f"request {flight.client.id} routing failed after exhausting "
            f"its retry budget: {err}", last_error=err))

    def _defer(self, flight, exclude):
        if self.retry_backoff_s > 0:
            flight.retry_at = time.monotonic() + self.retry_backoff_s
            flight.retry_exclude = exclude
        else:
            self._dispatch(flight, exclude)

    # -- disaggregated prefill/decode ---------------------------------------

    def _start_migration(self, flight, prefill_replica, version):
        """Kick the KV migration off the engine callback thread. The
        adoption blocks until the decode engine's next step boundary,
        and that engine's own done-callbacks need the Router lock —
        migrating under the lock would deadlock the fleet."""
        threading.Thread(
            target=self._migrate_then_decode,
            args=(flight, prefill_replica, version),
            name=f"{self.name}-kv-migrate", daemon=True).start()

    def _migrate_then_decode(self, flight, prefill_replica, version):
        """Stream the prefill replica's finished KV blocks to a decode
        replica, then dispatch the decode leg there (pinned to the
        prefill weight version — adopted KV must never meet different
        weights). Any migration failure degrades to ordinary colocated
        dispatch; the request stays replayable throughout."""
        from .migrate import migrate_prefix

        with self._lock:
            if flight.client.done():
                return
            target = self._pick(frozenset((prefill_replica,)),
                                version=version)
        adopted = 0
        if target is not None and target.engine is not None \
                and prefill_replica.engine is not None:
            try:
                adopted = migrate_prefix(
                    prefill_replica.engine, target.engine,
                    flight.client.payload, mailbox=self._kv_mailbox,
                    deadline_s=self._migrate_deadline_s)
            except Exception:  # noqa: BLE001 — degrade, don't fail
                self.metrics.inc("kv_migrate_faults")
        with self._lock:
            if flight.client.done():
                return
            if adopted:
                flight.kv_state = "migrated"
                flight.prefer = target
                if flight.pin is None and version is not None:
                    flight.pin = version
            else:
                flight.kv_state = "fallback"
            self._dispatch(flight, frozenset())

    def _attempt_done_cb(self, attempt):
        """Done-callback on every attempt future; runs on the engine
        (or cancelling) thread. First-wins on the client request makes
        duplicate outcomes — hedge losers, a hung replica's late
        completion — harmless, but we count them for certification."""
        with self._lock:
            flight = self._attempt_index.pop(attempt.id, None)
            if flight is None:
                return
            replica, _ = flight.attempts.get(attempt.id, (None, None))
            att_version = flight.versions.get(attempt.id)
            if replica is not None:
                replica.load = max(replica.load - 1, 0)
            was_stale = attempt.id in flight.stale
            flight.live.discard(attempt.id)
            flight.stale.discard(attempt.id)
            if was_stale:
                self.metrics.inc("stale_attempts")
                return
            err = attempt._error
            if err is None:
                if replica is not None:
                    replica.breaker.record_success()
                if attempt.id in flight.prefill_ids:
                    # disaggregated prefill leg: its one produced token
                    # is discarded — migrate the KV blocks and dispatch
                    # the decode leg (off-thread: migration waits on the
                    # decode engine's step boundary, which must not
                    # happen under the Router lock)
                    if not flight.client.done():
                        self._start_migration(flight, replica, att_version)
                    return
                if self._finish_ok(flight, attempt._value):
                    if attempt.id in flight.hedge_ids:
                        self.metrics.inc("hedge_wins")
                else:
                    self.metrics.inc("duplicates_suppressed")
                return
            if flight.client.done():
                return
            if replica is not None and not isinstance(
                    err, (RequestCancelled, DeadlineExceededError)):
                replica.breaker.record_failure()
            self._attempt_failed(flight, replica, err, version=att_version)

    def _attempt_failed(self, flight, replica, err, version=None):
        if flight.client.done():
            return
        if flight.active():
            # a sibling (hedge) attempt is still running — let it win
            # rather than charging the request's budgets
            return
        if isinstance(err, ReplicaDiedError):
            self._replay(flight, replica, err, version=version)
            return
        if retriable(err) and flight.retries_left > 0:
            flight.retries_left -= 1
            self.metrics.inc("retries")
            exclude = frozenset() if replica is None \
                else frozenset((replica,))
            self._defer(flight, exclude)
            return
        if retriable(err):
            self.metrics.inc("retry_budget_exhausted")
            err = RetriesExhaustedError(
                f"request {flight.client.id} failed after exhausting its "
                f"retry budget: {err}", last_error=err)
        self._finish_fail(flight, err)

    def _replay(self, flight, replica, err, version=None):
        """Failover: re-run a dead replica's request from its original
        prompt on a healthy sibling. Charged to the replay budget, not
        the retry budget. The replay is PINNED to the weight version
        the dead attempt decoded on: same version stays bitwise; a
        retired version fails retriable (`VersionRetiredError`) rather
        than silently re-decoding on different weights."""
        if flight.replays_left <= 0:
            self._finish_fail(flight, err)
            return
        flight.replays_left -= 1
        self.metrics.inc("replays")
        if flight.pin is None and version is not None:
            flight.pin = version
        if flight.pin is not None:
            self.metrics.inc("replays_pinned")
        try:
            faults.fault_point("serving.replay")
        except Exception as e:  # noqa: BLE001 — replay path failure
            self._finish_fail(flight, ReplicaDiedError(
                f"failover replay of request {flight.client.id} "
                f"failed: {e}"))
            return
        exclude = frozenset() if replica is None else frozenset((replica,))
        self._dispatch(flight, exclude)

    def _on_replica_death(self, replica, err):
        """ReplicaSet hook, called BEFORE the dead engine is abandoned:
        stale-mark every live attempt on it (their late outcomes must
        not reach clients or breakers) and replay each affected flight
        elsewhere. Runs on the supervisor (or kill-caller) thread."""
        with self._lock:
            affected = []
            for aid, flight in list(self._attempt_index.items()):
                rep, _ = flight.attempts.get(aid, (None, None))
                if rep is replica and aid in flight.live \
                        and aid not in flight.stale:
                    flight.stale.add(aid)
                    if flight not in (f for f, _ in affected):
                        affected.append((flight, aid))
            seen = set()
            for flight, aid in affected:
                if id(flight) in seen:
                    continue
                seen.add(id(flight))
                if flight.client.done():
                    continue
                self._replay(flight, replica, err,
                             version=flight.versions.get(aid))

    def _finish_ok(self, flight, value):
        if flight.client._complete(value):
            self.metrics.inc("fleet_completed")
            return True
        return False

    def _finish_fail(self, flight, err):
        if flight.client._fail(err):
            self.metrics.inc("fleet_failed")
            return True
        return False

    def _client_done_cb(self, client):
        """Runs once per client request, on whatever thread resolved it
        (engine success, router failure, or client cancel): cancel all
        still-pending attempts and drop the flight."""
        with self._lock:
            flight = self._flights.pop(client.id, None)
            if flight is None:
                return
            for aid in list(flight.live):
                if aid in flight.stale:
                    continue
                flight.stale.add(aid)
                _, att = flight.attempts[aid]
                att.cancel()

    # -- supervisor ---------------------------------------------------------

    def _supervise(self):
        while not self._stop.wait(self._tick_s):
            try:
                now = time.monotonic()
                self.replica_set.poll(now)
                self._brownout_tick()
                self._hedge_tick(now)
                self._flight_tick(now)
                if self.autoscaler is not None:
                    self.autoscaler.tick(now)
            except Exception:  # noqa: BLE001 — the supervisor never dies
                self.metrics.inc("supervisor_errors")

    def _brownout_tick(self):
        if self._brownout_force is not None:
            return
        cap = self.replica_set.capacity()
        if cap == 0:
            # nothing healthy: maximum degradation until a restart lands
            self._brownout = True
            return
        frac = self.replica_set.in_flight() / cap
        if not self._brownout and frac >= self._brownout_high:
            self._brownout = True
            self.metrics.inc("brownout_entries")
        elif self._brownout and frac <= self._brownout_low:
            self._brownout = False

    def _hedge_delay(self):
        if self._hedge_after_s is not None:
            return self._hedge_after_s
        p95 = self.metrics.latency_percentiles("e2e", (95,))[95]
        if p95 is None:
            return None   # no signal yet: don't hedge blind
        return max(self._hedge_min_s, 2.0 * p95)

    def _hedge_tick(self, now):
        if not self._hedge_enabled:
            return
        delay = self._hedge_delay()
        if delay is None:
            return
        with self._lock:
            for flight in list(self._flights.values()):
                if flight.hedged or flight.parked or flight.client.done():
                    continue
                active = flight.active()
                if len(active) != 1 or flight.last_dispatch is None:
                    continue
                if active[0] in flight.prefill_ids:
                    # never hedge a prefill leg: its value is discarded
                    # and a duplicate would double the KV migration
                    continue
                if now - flight.last_dispatch < delay:
                    continue
                flight.hedged = True
                exclude = frozenset(flight.attempts[aid][0]
                                    for aid in active)
                # hedge on the SAME weight version as the active
                # attempt: first-wins between the pair stays bitwise
                self._dispatch(flight, exclude, hedge=True,
                               version=flight.versions.get(active[0]))

    def _flight_tick(self, now):
        """Deferred retries, parked re-dispatch, deadline sweep."""
        with self._lock:
            for flight in list(self._flights.values()):
                client = flight.client
                if client.done():
                    continue
                if client.deadline is not None and now > client.deadline \
                        and not flight.active():
                    self._finish_fail(flight, DeadlineExceededError(
                        f"request {client.id} deadline exceeded while "
                        "awaiting redispatch"))
                    continue
                if flight.retry_at is not None and now >= flight.retry_at:
                    flight.retry_at, exclude = None, flight.retry_exclude
                    flight.retry_exclude = None
                    self._dispatch(flight, exclude or frozenset())
                elif flight.parked:
                    self._dispatch(flight)
