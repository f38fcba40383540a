"""Serving metrics registry: counters, occupancy, latency percentiles
(counterpart of paddle_tpu/serving/metrics.py). `snapshot()` is the
JSON view; `observe.prometheus_text(serving=...)` (what
`Server.metrics_prometheus` and `http_front`'s ``/metrics`` serve)
exports the same registry as Prometheus text.

Counter names mirror the admission queue's (`submitted`, `accepted`,
`rejected_queue_full`, `rejected_closed`, `timeouts`, `cancelled`) plus
the engine's `admitted`, `completed`, `failed`, `steps`, `tokens_out`,
`prefills`, `prefill_tokens`, `prompt_tokens`, `prefix_lookups`,
`prefix_hit_blocks`, `prefix_hit_tokens`, `cow_splits`,
`rejected_capacity` and `step_errors`; speculative decoding's
`spec_drafted_tokens` / `spec_accepted_tokens` / `spec_rejected_tokens`
/ `spec_rounds` / `spec_draft_faults` (fed by `observe_spec`, surfaced
under snapshot()["speculative"] with per-slot acceptance rates); the
adapter bank's `adapter_swaps`; the spill tier's `kv_spilled_blocks` /
`kv_restored_blocks` / `kv_invalidated_blocks` / `kv_spill_bytes` /
`kv_restore_corrupt` / `kv_restore_fenced` / `kv_spill_errors`
(surfaced under snapshot()["kvstore"]); KV migration's
`kv_migrations` / `kv_migrate_blocks` / `kv_migrate_bytes`; and the
batcher's `batches`. Latency series: `queue`, `e2e`, `prefill`,
`decode`, `step` and `kv_restore` (seconds). The fleet (fleet.py) adds
its own family over the same registry: `fleet_submitted` /
`fleet_completed` / `fleet_failed` (client-level, exactly-once),
`routed`, `retries`, `replays`, `hedges`, `hedge_wins`,
`duplicates_suppressed`, `stale_attempts`, `parked`, `replica_deaths`,
`replica_restarts`, `brownout_entries`, `brownout_sheds`,
`retry_budget_exhausted`, `supervisor_errors`, `replicas_added` /
`replicas_removed`, `drains_started`, `drain_errors`, `scale_failures`,
`affinity_hits` / `affinity_faults` and `kv_migrate_faults`; a
disaggregated replica's role (`note_role`) shows under
snapshot()["disagg"]. Multi-tenant serving bills per-tenant counters,
latency and gauges via `tenant_inc` / `tenant_observe_latency` /
`tenant_set_gauge`, surfaced under snapshot()["tenants"]. Every inc()
also bumps the global `framework.monitor` counter ``serving.<name>``.
"""

from __future__ import annotations

import json
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
        self._spec_slots: dict = {}   # slot -> [drafted, accepted]
        self._role = None             # disagg role ('prefill'/'decode')
        # tenant name -> {"counters": {...}, "latency": [s],
        # "gauges": {...}}; created lazily, absent without tenancy
        self._tenants: dict = {}
        self._started = time.monotonic()

    def note_role(self, role):
        """Disaggregation role of the replica this registry serves
        ('any' / 'prefill' / 'decode'), shown under
        snapshot()["disagg"]."""
        with self._lock:
            self._role = str(role)

    def set_gauge(self, name, value):
        """Last-write-wins scalar (e.g. `dequant_path` = 1.0 while an
        int8-frozen engine serves)."""
        with self._lock:
            self._gauges[name] = float(value)

    def observe_spec(self, slot, drafted, accepted):
        """One speculative round's outcome for one slot: `drafted`
        proposals went into the verify step, `accepted` survived.
        Feeds the spec_* counters and the per-slot acceptance rates."""
        with self._lock:
            cell = self._spec_slots.setdefault(int(slot), [0, 0])
            cell[0] += int(drafted)
            cell[1] += int(accepted)
        self.inc("spec_drafted_tokens", int(drafted))
        self.inc("spec_accepted_tokens", int(accepted))
        self.inc("spec_rejected_tokens", int(drafted) - int(accepted))

    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        monitor.stat_add(f"serving.{name}", n)

    def get(self, name):
        with self._lock:
            return self._counters.get(name, 0)

    # -- per-tenant accounting -----------------------------------------------

    def _tenant_cell(self, tenant):
        # caller holds self._lock
        cell = self._tenants.get(tenant)
        if cell is None:
            cell = {"counters": {}, "latency": [], "gauges": {}}
            self._tenants[str(tenant)] = cell
        return cell

    def tenant_inc(self, tenant, name, n=1):
        """Bump one tenant-scoped counter (`submitted`, `shed`,
        `completed`, `failed`, `tokens_out`, ...)."""
        if tenant is None:
            return
        with self._lock:
            c = self._tenant_cell(tenant)["counters"]
            c[name] = c.get(name, 0) + n
        monitor.stat_add(f"serving.tenant.{tenant}.{name}", n)

    def tenant_observe_latency(self, tenant, seconds):
        """One end-to-end latency sample billed to `tenant`."""
        if tenant is None:
            return
        with self._lock:
            series = self._tenant_cell(tenant)["latency"]
            series.append(float(seconds))
            if len(series) > _MAX_SAMPLES:
                del series[:len(series) - _MAX_SAMPLES]

    def tenant_set_gauge(self, tenant, name, value):
        """Last-write-wins tenant-scoped scalar (e.g. remaining token
        budget)."""
        if tenant is None:
            return
        with self._lock:
            self._tenant_cell(tenant)["gauges"][name] = float(value)

    def tenant_get(self, tenant, name):
        with self._lock:
            cell = self._tenants.get(tenant)
            return cell["counters"].get(name, 0) if cell else 0

    def tenant_latency_percentiles(self, tenant, ps=(50, 95, 99)):
        with self._lock:
            cell = self._tenants.get(tenant)
            series = list(cell["latency"]) if cell else []
        if not series:
            return {p: None for p in ps}
        return {p: percentile(series, p) for p in ps}

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

    def latency_percentiles(self, kind, ps=(50, 95, 99), last=None):
        """{p: seconds} over the recorded `kind` series. ``last``
        restricts to the most recent N samples — the autoscaler's
        sliding SLO window, so old congestion doesn't pin the signal
        high after the fleet recovers."""
        with self._lock:
            series = list(self._latency.get(kind, ()))
        if last is not None:
            series = series[-int(last):]
        if not series:
            return {p: None for p in ps}
        return {p: percentile(series, p) for p in ps}

    def snapshot(self, queue_depth=None):
        """One JSON-able view: counters, gauges, QPS, tokens/s,
        occupancy, KV blocks, prefix cache, chunked prefill and
        p50/p95/p99 (and the sum) per latency series."""
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
            spec_slots = {k: tuple(v) for k, v in self._spec_slots.items()}
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
        if counters.get("kv_spilled_blocks") \
                or counters.get("kv_restored_blocks") \
                or counters.get("kv_invalidated_blocks") \
                or counters.get("kv_restore_corrupt"):
            snap["kvstore"] = {
                "spilled_blocks": counters.get("kv_spilled_blocks", 0),
                "restored_blocks": counters.get("kv_restored_blocks", 0),
                "invalidated_blocks":
                    counters.get("kv_invalidated_blocks", 0),
                "spill_bytes": counters.get("kv_spill_bytes", 0),
                "restore_corrupt": counters.get("kv_restore_corrupt", 0),
                "restore_fenced": counters.get("kv_restore_fenced", 0),
                "spill_errors": counters.get("kv_spill_errors", 0),
            }
        if counters.get("spec_drafted_tokens") or spec_slots \
                or gauges.get("dequant_path"):
            drafted = counters.get("spec_drafted_tokens", 0)
            accepted = counters.get("spec_accepted_tokens", 0)
            snap["speculative"] = {
                "drafted_tokens": drafted,
                "accepted_tokens": accepted,
                "rejected_tokens": counters.get("spec_rejected_tokens", 0),
                "rounds": counters.get("spec_rounds", 0),
                "draft_faults": counters.get("spec_draft_faults", 0),
                "acceptance_rate": accepted / drafted if drafted else 0.0,
                "per_slot_acceptance": {
                    str(s): a / d if d else 0.0
                    for s, (d, a) in sorted(spec_slots.items())},
                "dequant_path": gauges.get("dequant_path", 0.0),
            }
        if counters.get("prefill_tokens"):
            steps = counters.get("steps", 0)
            snap["chunked_prefill"] = {
                "tokens": counters["prefill_tokens"],
                "tokens_per_step":
                    counters["prefill_tokens"] / steps if steps else 0.0,
            }
        with self._lock:
            role = self._role
            tenants = {
                t: {"counters": dict(c["counters"]),
                    "latency": list(c["latency"]),
                    "gauges": dict(c["gauges"])}
                for t, c in self._tenants.items()}
        if role is not None or counters.get("kv_migrations") \
                or counters.get("kv_migrate_faults"):
            snap["disagg"] = {
                "role": role or "any",
                "kv_migrations": counters.get("kv_migrations", 0),
                "kv_migrate_blocks": counters.get("kv_migrate_blocks", 0),
                "kv_migrate_bytes": counters.get("kv_migrate_bytes", 0),
                "kv_migrate_faults": counters.get("kv_migrate_faults", 0),
            }
        if tenants:
            snap["tenants"] = {}
            for t in sorted(tenants):
                cell = tenants[t]
                c, series = cell["counters"], cell["latency"]
                entry = {
                    "counters": c,
                    "qps": c.get("completed", 0) / elapsed,
                    "tokens_per_s": c.get("tokens_out", 0) / elapsed,
                    "gauges": cell["gauges"],
                }
                if series:
                    entry["latency_s"] = {
                        "count": len(series),
                        "p50": percentile(series, 50),
                        "p95": percentile(series, 95),
                        "p99": percentile(series, 99),
                        "max": max(series),
                    }
                snap["tenants"][t] = entry
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
                    "sum": sum(series),
                }
        return snap

    def to_json(self, queue_depth=None, **dump_kw):
        return json.dumps(self.snapshot(queue_depth=queue_depth),
                          **dump_kw)
