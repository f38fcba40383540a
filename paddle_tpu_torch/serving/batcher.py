"""Dynamic batcher: coalesce concurrent single-sample requests into
shape-bucketed, padded batches (counterpart of
paddle_tpu/serving/batcher.py).

Every flush pads up to a bucket ladder (powers of two capped at
`max_batch`), so a batch function sees only a handful of shapes — the
ones `warmup` runs once each before traffic. PyTorch runs eagerly, so
there is no trace and no ``jit`` option: a compile is the first run at
a new padded-batch (shape, dtype) signature, recorded as
``serving.batch`` in `observe.retrace` and counted per bucket in
`compile_counts` (a sample shape drifting inside a bucket counts
again, as a retrace does in the reference). A ``strict_shapes=True``
batcher, once warmed, runs every flush under `observe.no_retrace()`,
so such a drift raises. Every flush runs in a ``serving.batch`` span.

The batch function runs on the batcher's worker thread, so it enters
its own thread-local modes (``torch.no_grad``, autocast): modes entered
around `start()` stay on the caller's thread. The worker does enter
``torch.no_grad`` for it.

Fault site: ``serving.batch`` fires once per flush (delay = slow model,
raise = batch-level failure propagated to every member request).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import observe, profiler
from ..framework import faults
from ..framework.flags import flag
from .queueing import AdmissionQueue, Request

__all__ = ["bucket_ladder", "bucket_for", "pad_batch", "DynamicBatcher"]


def bucket_ladder(max_batch):
    """Powers of two up to and including `max_batch` (which is always
    the top rung even when not a power of two)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


def bucket_for(n, ladder):
    """Smallest rung >= n."""
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds top bucket {ladder[-1]}")


def pad_batch(batch, bucket):
    """Stack samples into [n, ...] and pad axis 0 up to `bucket` by
    repeating the last sample (repeat, not zeros: keeps padded rows
    numerically tame for models with normalisation over the batch)."""
    x = np.stack([np.asarray(s) for s in batch])
    if x.shape[0] < bucket:
        fill = np.broadcast_to(x[-1:], (bucket - x.shape[0],) + x.shape[1:])
        x = np.concatenate([x, fill], axis=0)
    return x


def _row(out, i):
    """Row `i` of every leaf of a batch output (dict / list / tuple of
    numpy arrays or tensors), as numpy."""
    if isinstance(out, dict):
        return {k: _row(v, i) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_row(v, i) for v in out)
    if isinstance(out, torch.Tensor):
        return out[i].detach().cpu().numpy()
    return np.asarray(out[i])


class DynamicBatcher:
    """Queue + assembler + bucketed executor around a batch function.

    `fn` maps one batched numpy array [n, ...] to an array, a tensor or
    a dict / list / tuple of them with leading axis n.
    """

    def __init__(self, fn, *, max_batch=None, max_wait_s=0.002,
                 queue_cap=None, metrics=None, strict_shapes=False):
        self._fn = fn
        self._strict = strict_shapes
        self._warmed = False
        self.max_batch = max_batch or flag("FLAGS_serving_max_batch")
        self.max_wait_s = max_wait_s
        self.ladder = bucket_ladder(self.max_batch)
        self.metrics = metrics
        self.queue = AdmissionQueue(
            queue_cap or flag("FLAGS_serving_queue_cap"), metrics=metrics)
        self._compiles: dict = {}   # bucket -> compiles (new signatures)
        self._signatures: set = set()
        self._thread = None

    @property
    def compile_counts(self):
        """bucket size -> number of compilations (new signatures)."""
        return dict(self._compiles)

    # -- synchronous bucketed execution (also the worker's core) ------------

    def run_batch(self, samples):
        """Pad `samples` to their bucket, run once, return the first
        len(samples) outputs as numpy. Deterministic (no queue/thread
        involved) — this is what warmup calls."""
        import contextlib

        bucket = bucket_for(len(samples), self.ladder)
        x = pad_batch(samples, bucket)
        guard = observe.no_retrace() if self._strict and self._warmed \
            else contextlib.nullcontext()
        with profiler.RecordEvent("serving.batch", cat="serving"), guard:
            sig = observe.signature_of(x)
            if sig not in self._signatures:
                observe.record_compile("serving.batch", signature=sig)
                self._signatures.add(sig)
                self._compiles[bucket] = self._compiles.get(bucket, 0) + 1
            with torch.no_grad():
                out = self._fn(x)
        return [_row(out, i) for i in range(len(samples))]

    def warmup(self, sample):
        """Run every rung of the ladder once before traffic."""
        for bucket in self.ladder:
            self.run_batch([sample] * bucket)
        self._warmed = True
        return dict(self._compiles)

    # -- threaded serving ---------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        return self

    def submit(self, sample, *, timeout=None):
        """Enqueue one sample; returns its `Request` future."""
        if timeout is None:
            timeout = flag("FLAGS_serving_default_timeout_s") or None
        return self.queue.submit(Request(sample, timeout=timeout))

    def __call__(self, sample, *, timeout=None):
        return self.submit(sample, timeout=timeout).result(timeout)

    def close(self, drain=True):
        self.queue.close(drain=drain)
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _collect(self):
        """One batch: block for the first member, then fill up to
        max_batch within max_wait_s."""
        first = self.queue.pop(timeout=0.1)
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            nxt = self.queue.pop(timeout=remaining)
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _loop(self):
        while not self.queue.drained():
            batch = self._collect()
            if not batch:
                continue
            try:
                faults.fault_point("serving.batch", batch)
                outs = self.run_batch([r.payload for r in batch])
            except Exception as e:  # noqa: BLE001 — fail members, live on
                for r in batch:
                    r._fail(e)
                if self.metrics is not None:
                    self.metrics.inc("failed", len(batch))
                continue
            now = time.monotonic()
            for r, out in zip(batch, outs):
                r._complete(out)
                if self.metrics is not None:
                    self.metrics.observe_latency("e2e", now - r.arrival)
            if self.metrics is not None:
                self.metrics.inc("completed", len(batch))
                self.metrics.inc("batches")
                self.metrics.observe_occupancy(len(batch), self.max_batch)
