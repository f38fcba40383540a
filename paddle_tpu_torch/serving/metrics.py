"""Serving metrics registry: counters, occupancy, latency percentiles
(the single-engine part of paddle_tpu/serving/metrics.py).

Counter names mirror the admission queue's (`submitted`, `accepted`,
`rejected_queue_full`, `rejected_closed`, `timeouts`, `cancelled`) plus
the engine's `admitted`, `completed`, `failed`, `steps`, `tokens_out`,
`prefills`, `prefill_tokens`, `prompt_tokens`, `prefix_lookups`,
`prefix_hit_blocks`, `prefix_hit_tokens`, `cow_splits`,
`rejected_capacity` and `step_errors`. Latency series: `queue`, `e2e`,
`prefill`, `decode` and `step` (seconds). Every inc() also bumps the
global `framework.monitor` counter ``serving.<name>``.
"""

from __future__ import annotations

import threading
import time

from ..framework import monitor
from ..utils.stats import percentile

__all__ = ["ServingMetrics", "percentile"]

# keep at most this many samples per latency series (fifo window)
_MAX_SAMPLES = 65536


class ServingMetrics:
    """Thread-safe counters + gauges + occupancy + latency series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._latency: dict = {}      # kind -> [seconds]
        self._gauges: dict = {}       # name -> float (last-write-wins)
        self._occ_sum = 0.0
        self._occ_n = 0
        self._occ_max = 0.0
        self._blk_last = (0, 0)       # (in_use, total) at last step
        self._blk_sum = 0.0
        self._blk_n = 0
        self._blk_max = 0.0
        self._started = time.monotonic()

    def set_gauge(self, name, value):
        """Last-write-wins scalar (e.g. `dequant_path` = 1.0 while an
        int8-frozen engine serves)."""
        with self._lock:
            self._gauges[name] = float(value)

    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        monitor.stat_add(f"serving.{name}", n)

    def get(self, name):
        with self._lock:
            return self._counters.get(name, 0)

    def observe_latency(self, kind, seconds):
        with self._lock:
            series = self._latency.setdefault(kind, [])
            series.append(float(seconds))
            if len(series) > _MAX_SAMPLES:
                del series[:len(series) - _MAX_SAMPLES]

    def observe_occupancy(self, active, capacity):
        """One step sample of slot utilisation (active/capacity)."""
        frac = active / max(capacity, 1)
        with self._lock:
            self._occ_sum += frac
            self._occ_n += 1
            self._occ_max = max(self._occ_max, frac)

    def observe_blocks(self, in_use, total):
        """One step sample of KV block-pool utilisation."""
        frac = in_use / max(total, 1)
        with self._lock:
            self._blk_last = (int(in_use), int(total))
            self._blk_sum += frac
            self._blk_n += 1
            self._blk_max = max(self._blk_max, frac)

    def snapshot(self, queue_depth=None):
        """One JSON-able view: counters, gauges, QPS, tokens/s,
        occupancy, KV blocks, prefix cache, chunked prefill and
        p50/p95/p99 per latency series."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            latency = {k: list(v) for k, v in self._latency.items()}
            occ_avg = self._occ_sum / self._occ_n if self._occ_n else 0.0
            occ = {"avg": occ_avg, "max": self._occ_max,
                   "samples": self._occ_n}
            blk_last, blk_n = self._blk_last, self._blk_n
            blk_avg = self._blk_sum / self._blk_n if self._blk_n else 0.0
            blk_max = self._blk_max
            elapsed = max(time.monotonic() - self._started, 1e-9)
        snap = {
            "counters": counters,
            "gauges": gauges,
            "uptime_s": elapsed,
            "qps": counters.get("completed", 0) / elapsed,
            "tokens_per_s": counters.get("tokens_out", 0) / elapsed,
            "batch_occupancy": occ,
            "latency_s": {},
        }
        if blk_n:
            snap["kv_blocks"] = {
                "in_use": blk_last[0], "total": blk_last[1],
                "occupancy": blk_avg, "occupancy_max": blk_max,
                "samples": blk_n,
            }
        if counters.get("prefix_lookups"):
            prompt = counters.get("prompt_tokens", 0)
            hit = counters.get("prefix_hit_tokens", 0)
            snap["prefix_cache"] = {
                "lookups": counters["prefix_lookups"],
                "hit_blocks": counters.get("prefix_hit_blocks", 0),
                "hit_tokens": hit,
                "prompt_tokens": prompt,
                "hit_rate": hit / prompt if prompt else 0.0,
            }
        if counters.get("prefill_tokens"):
            steps = counters.get("steps", 0)
            snap["chunked_prefill"] = {
                "tokens": counters["prefill_tokens"],
                "tokens_per_step":
                    counters["prefill_tokens"] / steps if steps else 0.0,
            }
        if queue_depth is not None:
            snap["queue_depth"] = queue_depth
        for kind, series in latency.items():
            if series:
                snap["latency_s"][kind] = {
                    "count": len(series),
                    "p50": percentile(series, 50),
                    "p95": percentile(series, 95),
                    "p99": percentile(series, 99),
                    "max": max(series),
                }
        return snap

