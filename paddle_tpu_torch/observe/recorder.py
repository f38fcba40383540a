"""Flight recorder: an always-on black box for the training runtime
(counterpart of paddle_tpu/observe/recorder.py, with the same names).

A bounded ring of per-step records (step, loss, grad-norm, step wall
ms, device bytes in use, anomaly counter) plus out-of-band notes (fired
fault points, preemption requests, anomaly rollbacks). Recording costs
one deque append: loss / grad-norm / counter stay device tensors until
dump time, so the hot path never waits for the card (``float`` of a
CUDA tensor runs only inside `snapshot` / `dump`).

On a crash the ring is flushed to a JSON "black box" file; `dump()` is
wired into the preemption handler, the anomaly-rollback path, the
fault-injection `crash` action, and SIGTERM, so a post-mortem always
has the last N steps even when the process died mid-run."""

from __future__ import annotations

import collections
import contextlib
import json
import os
import signal
import tempfile
import threading
import time

__all__ = ["FlightRecorder", "flight", "flight_guard", "configure",
           "install_signal_handler"]


def _scalar(v):
    """Best-effort host conversion of a (possibly device-tensor) value;
    a CUDA tensor waits for the card here."""
    try:
        return float(v)
    except Exception:
        try:
            return repr(v)
        except Exception:
            return f"<unreadable {type(v).__name__}>"


class FlightRecorder:
    def __init__(self, capacity=None):
        if capacity is None:
            from ..framework import flags
            capacity = flags.flag("FLAGS_flight_recorder_capacity")
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._notes: collections.deque = collections.deque(maxlen=256)
        self._dumped = []

    def record_step(self, step, **fields):
        """Append one step record. Tensor-valued fields are kept lazy;
        they are converted to python floats only at dump time."""
        with self._lock:
            self._ring.append({"step": int(step), "t": time.time(),
                               **fields})

    def note(self, kind, **fields):
        """Out-of-band event (fault fired, preemption, rollback)."""
        with self._lock:
            self._notes.append({"kind": kind, "t": time.time(), **fields})

    def last(self):
        with self._lock:
            return dict(self._ring[-1]) if self._ring else None

    def snapshot(self):
        """Materialized (host-side) copy of the ring + notes."""
        with self._lock:
            ring = [dict(r) for r in self._ring]
            notes = [dict(n) for n in self._notes]
        for r in ring:
            for k, v in r.items():
                if not isinstance(v, (int, float, str, bool, type(None))):
                    r[k] = _scalar(v)
        return {"records": ring, "notes": notes}

    def dump(self, reason, path=None):
        """Flush the black box to a JSON file; returns the path."""
        from ..framework import flags, monitor

        snap = self.snapshot()
        snap["reason"] = reason
        snap["time"] = time.time()
        snap["pid"] = os.getpid()
        if path is None:
            d = flags.flag("FLAGS_flight_recorder_dir") or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight-{os.getpid()}-{int(time.time() * 1000)}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, default=repr)
        os.replace(tmp, path)  # atomic: a reader never sees a torn file
        with self._lock:
            self._dumped.append(path)
        monitor.stat_add("flight_dumps")
        return path

    def dumps(self):
        with self._lock:
            return list(self._dumped)

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._notes.clear()
            self._dumped.clear()


#: process-global recorder every runtime component reports into
flight = FlightRecorder.__new__(FlightRecorder)
flight._lock = threading.Lock()
flight._ring = collections.deque(maxlen=256)
flight._notes = collections.deque(maxlen=256)
flight._dumped = []


def configure(capacity=None):
    """Re-size the global ring from flags (keeps existing records)."""
    if capacity is None:
        from ..framework import flags
        capacity = flags.flag("FLAGS_flight_recorder_capacity")
    with flight._lock:
        if flight._ring.maxlen != capacity:
            flight._ring = collections.deque(flight._ring, maxlen=capacity)


@contextlib.contextmanager
def flight_guard(reason="exception"):
    """Dump the black box when the body raises, then re-raise.

    This is the in-process analogue of the `crash` fault action's dump:
    wrap a training loop in it and an injected `raise` fault (or any
    real exception) leaves a post-mortem file behind."""
    try:
        yield flight
    except BaseException as e:
        flight.note("exception", error=repr(e))
        flight.dump(f"{reason}:{type(e).__name__}")
        raise


_handler_installed = False


def install_signal_handler(signum=signal.SIGTERM):
    """Chain a SIGTERM handler that dumps the black box first."""
    global _handler_installed
    if _handler_installed or threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.getsignal(signum)

    def _on_signal(sig, frame):
        try:
            flight.dump(f"signal:{sig}")
        finally:
            if callable(prev):
                prev(sig, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(sig, signal.SIG_DFL)
                signal.raise_signal(sig)

    signal.signal(signum, _on_signal)
    _handler_installed = True
    return True
