"""Bounded admission queues + request futures for the serving runtime
(counterpart of paddle_tpu/serving/queueing.py, pure Python, same names
and semantics).

`AdmissionQueue` is the in-process contract of one engine: submit()
admits or sheds without blocking (a full queue raises the 429-style
`QueueFullError`), every request carries a deadline, and close() drains
or sheds. `Request` is the first-wins, exactly-once future the engines
and the fleet Router resolve.

Fault sites: ``serving.submit`` on every admission attempt (a `drop`
action sheds the request exactly as a full queue would),
``serving.dequeue`` on every pop by the batcher or decode engine.

Multi-tenant admission: `TenantFairQueue` keeps the same
submit/pop/requeue contract but runs deficit-round-robin weighted fair
queueing over per-tenant FIFOs — each scheduler visit credits a tenant
``quantum * weight`` tokens of deficit and serves its head while the
deficit covers the head's cost (prompt + max_new tokens), so a flash
crowd from one tenant cannot starve another's share. Per-tenant
token-bucket budgets shed over-budget submissions with the retriable
`TenantBudgetError` whose ``retry_after_s`` is derived from the
bucket's refill; fault site ``serving.admit_tenant`` fires per
admission decision (tagged with the tenant, ``drop`` = deterministic
budget shed).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from ..framework import faults, monitor
from ..framework.flags import flag

__all__ = [
    "ServingError", "QueueFullError", "CapacityExhaustedError",
    "ServerClosedError", "DeadlineExceededError", "RequestCancelled",
    "ReplicaDiedError", "RetriesExhaustedError", "BrownoutShedError",
    "TenantBudgetError", "Request", "AdmissionQueue", "TenantFairQueue",
]


class ServingError(RuntimeError):
    """Base of the serving-side request failures; `status` carries the
    HTTP status the optional front door maps it to, `retriable` whether
    a client (or the in-process fleet Router) may transparently retry
    the same request, and `retry_after_s` the backoff hint the HTTP
    front surfaces as a ``Retry-After`` header on 429/503."""

    status = 500
    retriable = False
    retry_after_s = 1.0


class QueueFullError(ServingError):
    """Load shed: the bounded admission queue is at capacity.
    Retriable — the overload is transient by construction."""

    status = 429
    retriable = True


class CapacityExhaustedError(ServingError):
    """The request's KV-block demand exceeds the whole physical pool —
    retriable (429): a smaller request, or a bigger
    FLAGS_serving_kv_blocks, would be admitted."""

    status = 429
    retriable = True


class ServerClosedError(ServingError):
    """Submitted after shutdown began (or pending at a non-drain stop).
    Retriable: a fresh server (or a restarted fleet replica) would
    accept the same request."""

    status = 503
    retriable = True


class DeadlineExceededError(ServingError):
    """The request's deadline passed while queued or mid-decode."""

    status = 504


class RequestCancelled(ServingError):
    """The client cancelled; the engine evicts at the next step."""

    status = 499


class ReplicaDiedError(ServingError):
    """The replica holding this request crashed or stopped heartbeating;
    the fleet Router replays the request from its original prompt on a
    healthy replica (failover), so a client normally never sees this —
    it surfaces only when every replay avenue is exhausted."""

    status = 503
    retriable = True


class VersionRetiredError(ServingError):
    """A failover replay was pinned to the weight version its original
    attempt decoded on, but no replica serves (or will rebuild to) that
    version any more — the rollout retired it. Replaying on different
    weights would silently break bitwise first-wins semantics, so the
    request fails retriable instead: the client resubmits and decodes
    cleanly on the current version."""

    status = 503
    retriable = True


class RetriesExhaustedError(ServingError):
    """A retriable failure outlived the request's retry budget; the
    final underlying error rides along as ``last_error``."""

    status = 503
    retriable = True

    def __init__(self, message, last_error=None):
        super().__init__(message)
        self.last_error = last_error


class BrownoutShedError(QueueFullError):
    """Shed by fleet brownout: under sustained overload, requests below
    the priority floor are rejected first (429, retriable)."""


class TenantBudgetError(QueueFullError):
    """Shed by per-tenant admission: the tenant's token-bucket budget
    is exhausted (429, retriable). ``retry_after_s`` is set per
    instance from the bucket's refill rate, so the HTTP front's
    ``Retry-After`` header tells the client exactly when the budget
    next covers a request."""

    def __init__(self, message, retry_after_s=1.0):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.001)


_ids = itertools.count(1)


class Request:
    """One unit of serving work + its future.

    `payload` is mode-specific (a 1-D prompt id array for the decode
    engine, one unbatched sample for the dynamic batcher); generation
    parameters ride along in `gen`, and `priority` (higher = more
    important) steers fleet brownout shedding. The completing thread
    calls `_complete`/`_fail`; clients block in `result()`.

    Resolution is FIRST-WINS and exactly-once: `_complete`/`_fail`
    return True only for the call that actually resolved the future, so
    a fleet Router can race a failover replay against a hung replica's
    late completion and deliver exactly one outcome to the client.
    Done-callbacks registered via `add_done_callback` fire exactly once,
    on the resolving thread, after the event is set.
    """

    def __init__(self, payload, *, timeout=None, priority=0, **gen):
        self.id = next(_ids)
        self.payload = payload
        self.gen = gen
        self.priority = priority
        self.arrival = time.monotonic()
        self.deadline = self.arrival + timeout if timeout else None
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._cancel = False
        self._lock = threading.Lock()
        self._callbacks: list = []
        self._wake = None     # queue-side nudge, attached on admission

    # -- client side --------------------------------------------------------

    def cancel(self):
        """Cancel: fails the future PROMPTLY with `RequestCancelled` (a
        client blocked in `result()` wakes immediately instead of at the
        engine's next step boundary) and flags the request so the queue
        sweeps it and the engine evicts its slot at the next boundary —
        the work is reclaimed, not just the wait."""
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

    def add_done_callback(self, fn):
        """Run ``fn(self)`` once the future resolves (immediately if it
        already has). Exceptions from ``fn`` are swallowed — a broken
        observer must not corrupt the completing thread."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001 — observer-only
            pass

    def result(self, timeout=None, cancel_on_timeout=False):
        """Block for the outcome. With ``cancel_on_timeout`` a client
        that gives up also cancels the request, so its queue slot /
        decode slot is reclaimed instead of leaking until the deadline
        (or forever, if it had none)."""
        if not self._event.wait(timeout):
            if cancel_on_timeout:
                self.cancel()
            raise TimeoutError(
                f"request {self.id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not done within {timeout}s")
        return self._error

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
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — observer-only
                pass
        return True

    def _complete(self, value):
        return self._resolve(value, None)

    def _fail(self, error):
        return self._resolve(None, error)


class AdmissionQueue:
    """Bounded FIFO with deadline-aware pops and graceful drain.

    submit() is the admission-control point: over-capacity submissions
    raise `QueueFullError` immediately (the fast 429) instead of
    blocking the client into an unbounded backlog; a closed queue raises
    `ServerClosedError`. pop() silently fails+skips requests whose
    deadline already passed — they never reach a slot.
    """

    def __init__(self, cap, *, metrics=None):
        if cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {cap}")
        self.cap = cap
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._drain = True
        self._metrics = metrics

    def _count(self, name, n=1):
        monitor.stat_add(f"serving.{name}", n)
        if self._metrics is not None:
            self._metrics.inc(name, n)

    @property
    def depth(self):
        with self._cond:
            return len(self._items)

    @property
    def closed(self):
        return self._closed

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
        """Nudge the queue condition (a cancelled request wakes a
        blocked pop so its entry is swept promptly, not lazily)."""
        with self._cond:
            self._cond.notify_all()

    def pop(self, timeout=0.0):
        """Next live request, or None when nothing arrived within
        `timeout` (or the queue is drained). Expired/cancelled requests
        are failed in place and skipped — their futures resolve OUTSIDE
        the queue lock, so done-callbacks may safely touch queues."""
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
        (FIFO order preserved). Used by the paged engine when the block
        pool can't hold the request right now — it waits for in-flight
        evictions instead of being shed. Works on a closed queue so a
        draining engine can still finish its backlog; no admission
        counters fire (the request was already counted)."""
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
        engine to finish; drain=False fails them all right now (futures
        resolve outside the queue lock)."""
        dropped: list = []
        with self._cond:
            self._closed = True
            self._drain = drain
            if not drain:
                while self._items:
                    dropped.append(self._items.popleft())
            self._cond.notify_all()
        for req in dropped:
            self._count("rejected_closed")
            req._fail(ServerClosedError(
                f"request {req.id} dropped: non-drain shutdown"))


class TenantFairQueue(AdmissionQueue):
    """Weighted-fair admission over per-tenant FIFOs.

    Same external contract as `AdmissionQueue` — submit admits or sheds
    without blocking, pop fails expired/cancelled entries outside the
    lock, requeue preserves head-of-line order, close/drained drive the
    engine's exit — but the pop order is deficit-round-robin: each
    arrival at a tenant's queue credits ``quantum * weight`` tokens of
    deficit, and the queue keeps serving while the deficit covers its
    head's cost (prompt + max_new tokens). A tenant that floods only
    drains its own share; everyone else's heads keep flowing at their
    weighted rate.

    With a `TenantDirectory` attached (``tenancy=``), each submission
    first debits the tenant's token-bucket budget — an over-budget
    request sheds with `TenantBudgetError` carrying the exact refill
    wait as ``retry_after_s``. Fault site ``serving.admit_tenant``
    fires per admission decision (tag = tenant name; ``drop`` = shed
    with the same typed 429)."""

    def __init__(self, cap, *, tenancy=None, quantum=None, metrics=None):
        super().__init__(cap, metrics=metrics)
        self.tenancy = tenancy
        self.quantum = int(quantum or flag("FLAGS_tenant_wfq_quantum"))
        self._queues: dict = {}      # tenant -> deque of Requests
        self._deficit: dict = {}     # tenant -> DRR token deficit
        self._rr: deque = deque()    # tenant rotation order
        self._head: deque = deque()  # requeued items: served first
        self._front_credited = False
        self._size = 0

    @staticmethod
    def _cost(request):
        """DRR cost of one request in tokens: prompt + decode budget —
        the same unit the tenant token-bucket debits."""
        payload = request.payload
        n = getattr(payload, "size", None)
        if n is None:
            n = len(payload) if hasattr(payload, "__len__") else 1
        return float(int(n) + int(request.gen.get("max_new_tokens", 16)))

    def _weight(self, tenant):
        if self.tenancy is None:
            return 1.0
        return max(float(self.tenancy.resolve(tenant).weight), 1e-3)

    def _tenant_inc(self, tenant, name, n=1):
        if self._metrics is not None and \
                hasattr(self._metrics, "tenant_inc"):
            self._metrics.tenant_inc(tenant, name, n)

    @property
    def depth(self):
        with self._cond:
            return self._size

    def tenant_depths(self):
        """Per-tenant backlog snapshot {tenant: queued} (requeued
        head-of-line items count against their own tenant)."""
        with self._cond:
            out = {t: len(q) for t, q in self._queues.items() if q}
            for req in self._head:
                t = req.gen.get("tenant") or "default"
                out[t] = out.get(t, 0) + 1
            return out

    def drained(self):
        with self._cond:
            return self._closed and not self._size

    def submit(self, request: Request):
        """Admit or shed. Budget debit -> ``serving.admit_tenant`` ->
        enqueue on the tenant's FIFO. Returns `request` for chaining."""
        self._count("submitted")
        tenant = request.gen.get("tenant") or "default"
        if faults.fault_point("serving.submit", request) is faults.DROP:
            self._count("rejected_queue_full")
            raise QueueFullError(
                f"request {request.id} shed (injected overload)")
        wait_hint = 1.0
        if self.tenancy is not None:
            spec = self.tenancy.resolve(tenant)
            ok, wait = spec.try_debit(self._cost(request))
            wait_hint = wait or wait_hint
            if not ok:
                self._count("rejected_budget")
                self._tenant_inc(tenant, "shed")
                raise TenantBudgetError(
                    f"request {request.id} shed: tenant {tenant!r} over "
                    f"token budget (refill in {wait:.3f}s)",
                    retry_after_s=wait)
        if faults.fault_point("serving.admit_tenant", request,
                              tag=tenant) is faults.DROP:
            self._count("rejected_budget")
            self._tenant_inc(tenant, "shed")
            raise TenantBudgetError(
                f"request {request.id} shed (injected tenant overload "
                f"for {tenant!r})", retry_after_s=wait_hint)
        with self._cond:
            if self._closed:
                self._count("rejected_closed")
                raise ServerClosedError(
                    f"request {request.id} rejected: server shutting down")
            if self._size >= self.cap:
                self._count("rejected_queue_full")
                self._tenant_inc(tenant, "shed")
                raise QueueFullError(
                    f"request {request.id} rejected: queue at capacity "
                    f"{self.cap}")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._deficit[tenant] = 0.0
                self._rr.append(tenant)
            q.append(request)
            self._size += 1
            request._wake = self._notify
            self._cond.notify_all()
        self._count("accepted")
        self._tenant_inc(tenant, "submitted")
        return request

    def _dead(self, req):
        """to_fail entry for a cancelled/expired request, else None."""
        if req.cancelled:
            return ("cancelled", req, RequestCancelled(
                f"request {req.id} cancelled while queued"))
        if req.expired():
            return ("timeouts", req, DeadlineExceededError(
                f"request {req.id} deadline exceeded after "
                f"{time.monotonic() - req.arrival:.3f}s in queue"))
        return None

    def _advance(self):
        self._rr.rotate(-1)
        self._front_credited = False

    def _pop_locked(self, to_fail):
        """One DRR scheduling decision under the lock. The rotation
        front keeps serving while its deficit covers head costs;
        crediting happens exactly once per arrival at a queue, so a
        front tenant cannot out-earn its rotation share. Terminates:
        every full rotation credits each live queue a positive amount,
        so some deficit eventually covers its (finite) head cost, and a
        sweep leaving nothing live exits with None."""
        while self._head:
            req = self._head.popleft()
            self._size -= 1
            dead = self._dead(req)
            if dead is None:
                return req
            to_fail.append(dead)
        while self._size:
            progressed = False
            for _ in range(len(self._rr)):
                t = self._rr[0]
                q = self._queues[t]
                while q:
                    dead = self._dead(q[0])
                    if dead is None:
                        break
                    to_fail.append(dead)
                    q.popleft()
                    self._size -= 1
                if not q:
                    self._deficit[t] = 0.0
                    self._advance()
                    continue
                progressed = True
                if not self._front_credited:
                    self._deficit[t] += self.quantum * self._weight(t)
                    self._front_credited = True
                if self._deficit[t] >= self._cost(q[0]):
                    self._deficit[t] -= self._cost(q[0])
                    self._size -= 1
                    return q.popleft()
                self._advance()
            if not progressed:
                return None
        return None

    def pop(self, timeout=0.0):
        """Next live request in weighted-fair order, or None."""
        deadline = time.monotonic() + timeout
        while True:
            got = None
            finished = False
            to_fail: list = []
            with self._cond:
                got = self._pop_locked(to_fail)
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
        """Head-of-line push-back (paged-engine pool-wait contract):
        requeued items are served before any DRR decision and carry no
        extra deficit charge — their cost was already debited."""
        with self._cond:
            self._head.appendleft(request)
            self._size += 1
            self._cond.notify_all()

    def wait_nonempty(self, timeout):
        with self._cond:
            if self._size or self._closed:
                return
            self._cond.wait(timeout)

    def close(self, drain=True):
        dropped: list = []
        with self._cond:
            self._closed = True
            self._drain = drain
            if not drain:
                while self._head:
                    dropped.append(self._head.popleft())
                for q in self._queues.values():
                    while q:
                        dropped.append(q.popleft())
                self._size = 0
            self._cond.notify_all()
        for req in dropped:
            self._count("rejected_closed")
            req._fail(ServerClosedError(
                f"request {req.id} dropped: non-drain shutdown"))
