"""Preemption handling: graceful SIGTERM/SIGUSR1 shutdown with an
emergency checkpoint and an exact resume (counterpart of
paddle_tpu/distributed/preempt.py, with the same names).

A scheduler that reclaims the machine (maintenance, spot reclaim)
delivers SIGTERM with a grace window. This module gives that a
first-class path:

1. `install()` registers signal handlers (SIGTERM + SIGUSR1, the
   conventional pre-preemption warning signal) that set a flag instead of
   killing the process.
2. Training loops call `poll()` at step/epoch boundaries; when
   `requested()` turns true they write an emergency checkpoint, drop a
   ``PREEMPTED`` marker file next to the checkpoints, and raise
   `PreemptedError` (`checkpoint.train_epoch_range`).
3. On restart the loop consumes the marker and resumes the exact step and
   RNG state from the emergency checkpoint — the loss trajectory
   continues as if never interrupted.

Testing: set FLAGS_simulate_preempt_at_step=N (env or set_flags) and the
Nth `poll()` reports a preemption deterministically — no real signals or
process kills needed for the tier-1 certification tests.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

from ..framework import monitor
from ..framework.errors import UnavailableError

__all__ = ["PreemptedError", "install", "uninstall", "requested",
           "request", "poll", "clear", "on_preempt", "write_marker",
           "consume_marker", "MARKER_NAME"]

MARKER_NAME = "PREEMPTED"

_lock = threading.Lock()
_requested = False
_reason = None
_poll_count = 0
_prev_handlers: dict = {}
_callbacks: list = []


def on_preempt(callback):
    """Register a callback fired exactly once, at the moment the FIRST
    preemption request lands (signal or simulated) — e.g. a GangWorker
    deregistering its heartbeat so peers and the supervisor observe the
    membership change without waiting for the beat to expire. Callbacks
    must be signal-safe-ish (no locks shared with the main loop) and
    must not raise into the drain path (exceptions are swallowed)."""
    with _lock:
        already = _requested
        if not already:
            _callbacks.append(callback)
    if already:  # late registration during an active preemption
        try:
            callback()
        except Exception:
            pass


class PreemptedError(UnavailableError):
    """Raised at a step boundary after the emergency checkpoint landed;
    the process should exit and let the scheduler/launcher restart it."""


def request(reason="signal"):
    """Mark this process as preempted (idempotent)."""
    global _requested, _reason
    with _lock:
        if not _requested:
            _requested = True
            _reason = reason
            monitor.stat_add("preemptions")
        else:
            return
    for cb in list(_callbacks):
        try:
            cb()
        except Exception:  # never let a hook break the drain path
            pass
    # black-box the last steps NOW: the grace window may not be long
    # enough for the step loop's checkpoint, but this dump is cheap
    try:
        from .. import observe

        observe.flight.note("preemption", reason=reason)
        observe.flight.dump(f"preempt:{reason}")
    except Exception:  # never let telemetry break the drain path
        pass


def _handler(signum, frame):
    request(reason=f"signal {signum}")
    # do NOT re-raise / exit here: the step loop finishes the current
    # step, checkpoints, then exits — that is the whole point


def install(signals=(signal.SIGTERM, signal.SIGUSR1)):
    """Register the deferred-exit handlers (idempotent; no-op off the
    main thread, where CPython forbids signal registration)."""
    try:
        for sig in signals:
            if sig not in _prev_handlers:
                _prev_handlers[sig] = signal.signal(sig, _handler)
    except ValueError:  # not the main thread
        pass


def uninstall():
    for sig, prev in list(_prev_handlers.items()):
        try:
            signal.signal(sig, prev)
        except ValueError:
            pass
        del _prev_handlers[sig]


def requested():
    return _requested


def reason():
    return _reason


def poll():
    """One step/epoch-boundary check. Advances the simulated-preemption
    schedule (FLAGS_simulate_preempt_at_step) and returns requested().

    Passes the ``preempt.poll`` fault site: ``drop`` suppresses this
    boundary's check (a missed poll — the loop keeps training and the
    preemption is noticed one boundary late), ``crash`` models death at
    the boundary itself."""
    global _poll_count
    from ..framework import faults as _faults
    from ..framework import flags as _flags

    if _faults.fault_point("preempt.poll") is _faults.DROP:
        return False
    with _lock:
        _poll_count += 1
        n = _poll_count
    at = _flags.flag("FLAGS_simulate_preempt_at_step")
    if at and n >= at:
        request(reason="simulated")
    return requested()


def clear():
    """Reset all preemption state (tests / after a handled resume)."""
    global _requested, _reason, _poll_count
    with _lock:
        _requested = False
        _reason = None
        _poll_count = 0
        del _callbacks[:]


# ---------------------------------------------------------------------------
# resume marker
# ---------------------------------------------------------------------------


def write_marker(directory, meta=None):
    """Atomically drop a PREEMPTED marker recording why/where training
    stopped; the restarted job reads it to distinguish 'resumed after
    preemption' from 'fresh start' (and tests assert exact-step resume)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, MARKER_NAME)
    rec = {"reason": _reason or "unknown", "ts": time.time()}
    rec.update(meta or {})
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
    return path


def consume_marker(directory):
    """Read-and-remove the marker; returns its dict or None."""
    path = os.path.join(directory, MARKER_NAME)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        os.remove(path)
    except OSError:
        pass
    monitor.stat_add("preempt_resumes")
    return rec
