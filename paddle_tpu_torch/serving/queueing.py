"""Bounded admission queue + request futures for the serving runtime
(own copy of the single-engine part of paddle_tpu/serving/queueing.py,
without the fleet/tenant error types and `TenantFairQueue`).

Fault sites: ``serving.submit`` on each admission attempt (a `drop`
action sheds exactly as a full queue would) and ``serving.dequeue`` on
each request a pop hands out.

`submit` never blocks the engine — it either admits within capacity or
sheds immediately (429-style `QueueFullError`), and every request
carries an absolute deadline checked both while queued and mid-decode.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from ..framework import faults, monitor

__all__ = [
    "ServingError", "QueueFullError", "CapacityExhaustedError",
    "ServerClosedError", "DeadlineExceededError", "RequestCancelled",
    "Request", "AdmissionQueue",
]


class ServingError(RuntimeError):
    """Base of the serving-side request failures; `status` carries the
    HTTP status a front door would map it to, `retriable` whether a
    client may transparently retry the same request, and
    `retry_after_s` the backoff hint for 429/503."""

    status = 500
    retriable = False
    retry_after_s = 1.0


class QueueFullError(ServingError):
    """Load shed: the bounded admission queue is at capacity."""

    status = 429
    retriable = True


class CapacityExhaustedError(ServingError):
    """The request's KV-block demand exceeds the whole physical pool."""

    status = 429
    retriable = True


class ServerClosedError(ServingError):
    """Submitted after shutdown began (or pending at a non-drain stop)."""

    status = 503
    retriable = True


class DeadlineExceededError(ServingError):
    """The request's deadline passed while queued or mid-decode."""

    status = 504


class RequestCancelled(ServingError):
    """The client cancelled; the engine evicts at the next step."""

    status = 499


_ids = itertools.count(1)


class Request:
    """One unit of serving work + its future.

    `payload` is the 1-D prompt id array; generation parameters ride
    along in `gen`. The engine thread calls `_complete`/`_fail` (first
    resolution wins, exactly once); clients block in `result()`.
    """

    def __init__(self, payload, *, timeout=None, **gen):
        self.id = next(_ids)
        self.payload = payload
        self.gen = gen
        self.arrival = time.monotonic()
        self.deadline = self.arrival + timeout if timeout else None
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._cancel = False
        self._lock = threading.Lock()
        self._wake = None     # queue-side nudge, attached on admission

    # -- client side --------------------------------------------------------

    def cancel(self):
        """Fail the future promptly with `RequestCancelled` and flag the
        request so the queue sweeps it and the engine evicts its slot at
        the next boundary."""
        self._cancel = True
        self._fail(RequestCancelled(f"request {self.id} cancelled"))
        wake = self._wake
        if wake is not None:
            wake()

    @property
    def cancelled(self):
        return self._cancel

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the outcome."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    # -- engine side --------------------------------------------------------

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def _resolve(self, value, error):
        with self._lock:
            if self._event.is_set():
                return False          # first resolution won; drop this one
            self._value = value
            self._error = error
            self._event.set()
        return True

    def _complete(self, value):
        return self._resolve(value, None)

    def _fail(self, error):
        return self._resolve(None, error)


class AdmissionQueue:
    """Bounded FIFO with deadline-aware pops and graceful drain.

    submit() is the admission-control point: over-capacity submissions
    raise `QueueFullError` immediately; a closed queue raises
    `ServerClosedError`. pop() fails+skips requests whose deadline
    already passed — they never reach a slot.
    """

    def __init__(self, cap, *, metrics=None):
        if cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {cap}")
        self.cap = cap
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._metrics = metrics

    def _count(self, name, n=1):
        monitor.stat_add(f"serving.{name}", n)
        if self._metrics is not None:
            self._metrics.inc(name, n)

    @property
    def depth(self):
        with self._cond:
            return len(self._items)

    def drained(self):
        """True once closed and empty — the engine's exit condition."""
        with self._cond:
            return self._closed and not self._items

    def submit(self, request: Request):
        """Admit or shed. Returns `request` for chaining."""
        self._count("submitted")
        if faults.fault_point("serving.submit", request) is faults.DROP:
            # deterministic overload: the drop action sheds exactly as a
            # full queue would
            self._count("rejected_queue_full")
            raise QueueFullError(
                f"request {request.id} shed (injected overload)")
        with self._cond:
            if self._closed:
                self._count("rejected_closed")
                raise ServerClosedError(
                    f"request {request.id} rejected: server shutting down")
            if len(self._items) >= self.cap:
                self._count("rejected_queue_full")
                raise QueueFullError(
                    f"request {request.id} rejected: queue at capacity "
                    f"{self.cap}")
            self._items.append(request)
            request._wake = self._notify
            self._cond.notify_all()
        self._count("accepted")
        return request

    def _notify(self):
        with self._cond:
            self._cond.notify_all()

    def pop(self, timeout=0.0):
        """Next live request, or None when nothing arrived within
        `timeout` (or the queue is drained). Expired/cancelled requests
        are failed (outside the queue lock) and skipped."""
        deadline = time.monotonic() + timeout
        while True:
            got = None
            finished = False
            to_fail: list = []
            with self._cond:
                while self._items:
                    req = self._items.popleft()
                    if req.cancelled:
                        to_fail.append(("cancelled", req, RequestCancelled(
                            f"request {req.id} cancelled while queued")))
                        continue
                    if req.expired():
                        to_fail.append((
                            "timeouts", req, DeadlineExceededError(
                                f"request {req.id} deadline exceeded "
                                f"after "
                                f"{time.monotonic() - req.arrival:.3f}s "
                                "in queue")))
                        continue
                    got = req
                    break
                if got is None:
                    if self._closed:
                        finished = True
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            finished = True
                        else:
                            self._cond.wait(remaining)
            for name, req, err in to_fail:
                self._count(name)
                req._fail(err)
            if got is not None:
                faults.fault_point("serving.dequeue", got)
                return got
            if finished:
                return None

    def requeue(self, request: Request):
        """Push an already-admitted request back to the queue *head*
        (used when the block pool can't hold it right now). No admission
        counters fire."""
        with self._cond:
            self._items.appendleft(request)
            self._cond.notify_all()

    def wait_nonempty(self, timeout):
        """Park until something is queued (or close/timeout)."""
        with self._cond:
            if self._items or self._closed:
                return
            self._cond.wait(timeout)

    def close(self, drain=True):
        """Stop admissions. drain=True leaves queued requests for the
        engine to finish; drain=False fails them all right now."""
        dropped: list = []
        with self._cond:
            self._closed = True
            if not drain:
                while self._items:
                    dropped.append(self._items.popleft())
            self._cond.notify_all()
        for req in dropped:
            self._count("rejected_closed")
            req._fail(ServerClosedError(
                f"request {req.id} dropped: non-drain shutdown"))
