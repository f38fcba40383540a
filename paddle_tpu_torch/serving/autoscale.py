"""SLO-aware autoscaler: grow/shrink the serving fleet on error budget
(counterpart of paddle_tpu/serving/autoscale.py, pure Python).

The `Autoscaler` watches the signals the fleet already exports — windowed
e2e p99 vs `FLAGS_fleet_slo_p99_ms`, in-flight / capacity utilisation,
backlog pressure (outstanding Router futures per decode slot — loud
even while a replica rebuild has stalled completions), and brownout
state — and converts sustained error-budget burn into membership
changes on the `ReplicaSet`:

- **Scale up** (overloaded, cooldown elapsed, below
  `FLAGS_fleet_max_replicas`): one `add_replica()` on a background
  thread — the build warms a fresh engine up and must never block the
  supervisor tick that drives heartbeat watchdogs. The newcomer warms
  up behind the restart path every rebuild uses and then turns
  healthy; at most one build is in flight at a time.
- **Scale down** (idle for a full cooldown, above
  `FLAGS_fleet_min_replicas`): drain-then-evict via
  `remove_replica(drain=True)` — non-blocking; the watchdog evicts the
  victim once its queue and slots empty, so shrinking the fleet loses
  and duplicates nothing.

Hysteresis is the pair of watermarks (`high_water`/`low_water` on
utilisation) plus the cooldown between *any* two actions; both
directions also require their condition to persist (`up_sustain_s`,
down = the cooldown itself), so a single slow request or one idle tick
never flaps the fleet. Every action failure increments
`scale_failures` and never kills the supervisor.

Gauges land in the global monitor registry each tick —
``fleet.target_replicas``, ``fleet.live_replicas``,
``fleet.slo_violation_ms`` (error-budget burn while windowed p99 is
over SLO) — next to the ``fleet.scale_events_up/down`` counters the
ReplicaSet bumps on every membership change (manual or autoscaled);
`observe.prometheus_text()` exports them as the ``paddle_fleet_*``
family.
"""

from __future__ import annotations

import threading
import time

from ..framework import monitor
from ..framework.flags import flag

__all__ = ["Autoscaler", "SLOWindow"]


class SLOWindow:
    """Freshness-gated windowed e2e p99 — the autoscaler's staleness
    rule factored out so the rollout canary/sustain SLO burn gate
    reads the IDENTICAL signal the autoscaler scales on.

    The percentile window is samples, not time: once traffic stops,
    old congested samples would pin p99 high forever. A window with no
    `fleet_completed` progress for `freshness_s` is stale — `p99_s()`
    returns None (no traffic means no SLO burn).
    """

    def __init__(self, metrics, *, kind="e2e", window=64,
                 freshness_s=5.0, counter="fleet_completed",
                 clock=time.monotonic):
        self.metrics = metrics
        self.kind = kind
        self.window = int(window)
        self.freshness_s = float(freshness_s)
        self.counter = counter
        self._clock = clock
        self._last = -1
        self._last_t = None

    def p99_s(self, now=None):
        """Windowed p99 in seconds, or None while the window is stale
        (no completions for `freshness_s`) or still empty."""
        now = self._clock() if now is None else now
        completed = self.metrics.get(self.counter)
        if completed != self._last:
            self._last = completed
            self._last_t = now
        if self._last_t is None or now - self._last_t >= self.freshness_s:
            return None
        return self.metrics.latency_percentiles(
            self.kind, (99,), last=self.window)[99]


class Autoscaler:
    """Drives `ReplicaSet.add_replica`/`remove_replica` from SLO burn.

    Constructed by `Router.start()` when the Router got `autoscale=`
    (True for flag defaults, or a kwargs dict), or by hand in tests:
    ``Autoscaler(router, ...)`` attaches itself as `router.autoscaler`
    and is then ticked by the Router's supervisor thread. `clock` is
    injectable so unit tests drive cooldowns without sleeping.
    """

    def __init__(self, router, *, min_replicas=None, max_replicas=None,
                 slo_p99_ms=None, cooldown_s=None, high_water=0.85,
                 low_water=0.30, backlog_factor=3.0, up_sustain_s=0.0,
                 window=64, clock=time.monotonic):
        self.router = router
        self.min_replicas = int(
            flag("FLAGS_fleet_min_replicas") if min_replicas is None
            else min_replicas)
        self.max_replicas = int(
            flag("FLAGS_fleet_max_replicas") if max_replicas is None
            else max_replicas)
        self.slo_p99_ms = float(
            flag("FLAGS_fleet_slo_p99_ms") if slo_p99_ms is None
            else slo_p99_ms)
        self.cooldown_s = float(
            flag("FLAGS_fleet_scale_cooldown_s") if cooldown_s is None
            else cooldown_s)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        if not 0.0 <= low_water < high_water:
            raise ValueError(
                f"need 0 <= low_water ({low_water}) < high_water "
                f"({high_water})")
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.backlog_factor = float(backlog_factor)
        self.up_sustain_s = float(up_sustain_s)
        self.window = int(window)
        self._clock = clock
        self._closed = False
        self._scale_thread = None     # at most one build in flight
        self._last_action = None      # clock time of last up/down
        self._over_since = None       # overload onset (sustain gate)
        self._idle_since = None       # idleness onset (sustain gate)
        self._last_tick = None
        # freshness-gated windowed p99 (shared with the rollout gate)
        self._slo = SLOWindow(router.metrics, window=self.window,
                              freshness_s=self.cooldown_s, clock=clock)
        self.target = None            # desired membership; set lazily
        self.violation_s = 0.0        # cumulative time over SLO
        self.decisions = {"up": 0, "down": 0}
        router.autoscaler = self

    # -- signals ------------------------------------------------------------

    def _signals(self, now):
        rs = self.router.replica_set
        # freshness-gated windowed p99 (SLOWindow): a window with no
        # completion for a full cooldown is stale and reads None — no
        # traffic means no SLO burn, so a quiet fleet never wedges at
        # peak size on old congested samples.
        p99 = self._slo.p99_s(now)
        over_slo = p99 is not None and p99 * 1e3 > self.slo_p99_ms
        util = rs.in_flight() / max(rs.capacity(), 1)
        # backlog pressure: outstanding Router futures per decode slot.
        # Unlike p99 (needs fresh completions) and util (diluted by the
        # queue caps in `capacity()`), this stays loud while a replica
        # rebuild has stalled completions — exactly when help is needed.
        pressure = self.router.in_flight / max(rs.slot_capacity(), 1)
        backlogged = pressure >= self.backlog_factor
        brown = self.router.brownout_active
        return {
            "p99_s": p99, "over_slo": over_slo, "util": util,
            "pressure": pressure, "brownout": brown,
            "overloaded": (over_slo or brown or backlogged
                           or util >= self.high_water),
            "idle": (util <= self.low_water and pressure <= 1.0
                     and not over_slo and not brown),
            "live": rs.live_replicas(), "members": rs.member_replicas(),
        }

    # -- the supervisor tick ------------------------------------------------

    def tick(self, now=None):
        """One control-loop pass; called from `Router._supervise` (and
        directly by tests). Never raises: action failures are counted
        and the fleet keeps serving at its current size."""
        if self._closed:
            return None
        now = self._clock() if now is None else now
        sig = self._signals(now)
        if self.target is None:
            self.target = sig["members"]
        # error-budget burn: integrate wall time spent over SLO
        if self._last_tick is not None and sig["over_slo"]:
            self.violation_s += max(now - self._last_tick, 0.0)
        self._last_tick = now
        monitor.stat_set("fleet.target_replicas", self.target)
        monitor.stat_set("fleet.live_replicas", sig["live"])
        monitor.stat_set("fleet.slo_violation_ms",
                         int(self.violation_s * 1e3))
        # sustain gates (hysteresis in time, not just level)
        self._over_since = (self._over_since or now) \
            if sig["overloaded"] else None
        self._idle_since = (self._idle_since or now) \
            if sig["idle"] else None
        in_cooldown = (self._last_action is not None
                       and now - self._last_action < self.cooldown_s)
        if in_cooldown:
            return sig
        building = (self._scale_thread is not None
                    and self._scale_thread.is_alive())
        if sig["overloaded"] and not building \
                and now - self._over_since >= self.up_sustain_s \
                and sig["members"] < self.max_replicas:
            self._scale_up(now, sig)
        elif sig["idle"] and not building \
                and now - self._idle_since >= self.cooldown_s \
                and sig["live"] > max(self.min_replicas, 1):
            self._scale_down(now, sig)
        return sig

    # -- actions ------------------------------------------------------------

    def _scale_up(self, now, sig):
        self.decisions["up"] += 1
        self.target = min(sig["members"] + 1, self.max_replicas)
        self._last_action = now

        def build():
            try:
                self.router.replica_set.add_replica()
            except Exception:  # noqa: BLE001 — fleet keeps serving
                self.router.metrics.inc("scale_failures")

        self._scale_thread = threading.Thread(
            target=build, name=f"{self.router.name}-scale-up",
            daemon=True)
        self._scale_thread.start()

    def _scale_down(self, now, sig):
        rs = self.router.replica_set
        # victim: least-loaded healthy replica, newest first — the
        # original floor replicas stay, scale-up surge capacity leaves
        victims = sorted(rs.healthy(),
                         key=lambda r: (r.load, -r.index))
        if not victims:
            return
        self.decisions["down"] += 1
        self.target = max(sig["members"] - 1, self.min_replicas)
        self._last_action = now
        try:
            rs.remove_replica(victims[0].name, drain=True)
        except Exception:  # noqa: BLE001 — e.g. lost a race with deaths
            self.router.metrics.inc("scale_failures")

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout=10.0):
        """Stop deciding; wait for an in-flight build to settle so a
        shutdown never races a half-built replica."""
        self._closed = True
        t = self._scale_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def snapshot(self):
        return {
            "target": self.target,
            "min": self.min_replicas, "max": self.max_replicas,
            "slo_p99_ms": self.slo_p99_ms,
            "cooldown_s": self.cooldown_s,
            "violation_s": self.violation_s,
            "decisions": dict(self.decisions),
            "building": (self._scale_thread is not None
                         and self._scale_thread.is_alive()),
        }
