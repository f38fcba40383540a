"""Unified telemetry export: one snapshot, two formats (counterpart of
paddle_tpu/observe/export.py, with the same families, names, types,
help strings, labels and order).

Folds the four registries that grew up independently — the
framework.monitor counters, per-server ServingMetrics, the step
timeline's phase aggregates, and the retrace audit — into a single
labeled view, exported either as a JSON snapshot (`snapshot()` /
`dump()`) or as Prometheus text exposition (`prometheus_text()`, what
the serving front serves on `GET /metrics` with an appropriate Accept
header).

Goodput accounting lives here because it is a pure fold over the
timeline: productive device time over total accounted wall time, with
checkpoint/restore/compile attributed and background (overlapped)
checkpoint writes excluded from the denominator.

Families whose subsystem the port does not have yet (the durable PS,
recommender serving, gang-supervised training, mesh-sharded serving)
are emitted at their zero monitor values, as the reference emits them
before those subsystems boot."""

from __future__ import annotations

import json
import os
import re
import time

from . import recorder, retrace
from .timeline import timeline as _timeline

__all__ = ["goodput", "snapshot", "dump", "prometheus_text"]


# phase name -> goodput category; phases not listed count as "other"
_GOODPUT_CATS = {
    "device-step": "productive",
    "compile": "compile",
    "checkpoint-snapshot": "checkpoint",
    "checkpoint-write": "checkpoint",
    "checkpoint-restore": "restore",
    "host-prep": "host",
    "h2d": "host",
    "sample": "host",
    "anomaly-readback": "host",
    # gang supervisor: teardown + backoff + respawn after a rank died
    # or stalled — wall time lost to the coordinated restart
    "gang-restart": "restart",
}
# background writer time overlaps the step thread: report it, but keep
# it out of the goodput denominator
_OVERLAPPED = {"checkpoint-write-async"}


def goodput(aggregates=None):
    """Goodput fractions from the timeline's phase aggregates."""
    if aggregates is None:
        aggregates = _timeline.aggregates()
    cats = {"productive": 0.0, "compile": 0.0, "checkpoint": 0.0,
            "restore": 0.0, "restart": 0.0, "host": 0.0, "other": 0.0}
    overlapped = 0.0
    for name, agg in aggregates.items():
        if name in _OVERLAPPED:
            overlapped += agg["total_s"]
            continue
        cats[_GOODPUT_CATS.get(name, "other")] += agg["total_s"]
    total = sum(cats.values())
    return {
        "categories_s": cats,
        "overlapped_s": overlapped,
        "accounted_s": total,
        "goodput": cats["productive"] / total if total else 0.0,
    }


def snapshot(serving=None):
    """One JSON-able dict across every registry."""
    from ..framework import monitor

    aggs = _timeline.aggregates()
    out = {
        "time": time.time(),
        "pid": os.getpid(),
        "monitor": monitor.stats(),
        "timeline": aggs,
        "goodput": goodput(aggs),
        "compiles": retrace.compile_events(),
        "flight": {
            "last": recorder.flight.snapshot()["records"][-1:],
            "dumps": recorder.flight.dumps(),
        },
        # durable-PS view mirrors the paddle_ps_* Prometheus family
        "ps": {stat.split(".", 1)[1]: monitor.stat_get(stat)
               for stat in _PS_METRICS},
        # recommender-serving view mirrors paddle_rec_*: lifetime
        # counters from monitor + computed gauges over the live caches
        "rec": dict(
            {stat.split(".", 1)[1]: monitor.stat_get(stat)
             for stat in _REC_METRICS},
            **{name.replace("paddle_rec_", ""): value
               for name, (value, _h) in _rec_gauges().items()}),
        # elastic-fleet view mirrors paddle_fleet_*: autoscaler gauges
        # + scale-event counters + SLO error-budget burn (in seconds)
        "fleet": dict(
            {stat.split(".", 1)[1]: monitor.stat_get(stat)
             for stat in _FLEET_METRICS},
            slo_violation_seconds=(
                monitor.stat_get("fleet.slo_violation_ms") / 1e3)),
        # gang-supervised training view mirrors paddle_gang_*: restart/
        # timeout counters + wall time lost to coordinated restarts +
        # live per-rank heartbeat ages from the supervisor registry
        "gang": dict(
            {stat.split(".", 1)[1]: monitor.stat_get(stat)
             for stat in _GANG_METRICS},
            restart_lost_seconds=(
                monitor.stat_get("gang.restart_lost_ms") / 1e3),
            heartbeat_ages=_gang().heartbeat_ages()),
        # mesh-sharded serving view mirrors paddle_serving_mesh_*: the
        # KV-migration counters (every ServingMetrics.inc also lands in
        # the monitor registry; an engine's role detail lives in
        # snapshot()["serving"]["disagg"] when a ServingMetrics registry
        # is passed)
        "mesh": {stat.split(".", 1)[1]: monitor.stat_get(stat)
                 for stat in _MESH_STATS},
        # persistent-KV-tier view mirrors paddle_serving_kvstore_*
        "kvstore": {stat.split(".", 1)[1]: monitor.stat_get(stat)
                    for stat in _KVSTORE_METRICS},
        # low-precision compute view mirrors paddle_lowp_*
        "lowp": {stat.split(".", 1)[1]: monitor.stat_get(stat)
                 for stat in _LOWP_METRICS},
    }
    if serving is not None:
        out["serving"] = serving.snapshot()
    return out


def dump(path, serving=None):
    """Write `snapshot()` to a JSON file; returns the path."""
    snap = snapshot(serving=serving)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=1, default=repr)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

#: monitor stat -> (prometheus name, type, help) for the durable-PS
#: family; emitted explicitly (ahead of the generic monitor dump, which
#: would mistype the gauges as counters) and mirrored in snapshot()["ps"]
_PS_METRICS = {
    "ps.wal_bytes": (
        "paddle_ps_wal_bytes", "gauge",
        "bytes appended to the PS write-ahead logs"),
    "ps.replication_lag_updates": (
        "paddle_ps_replication_lag_updates", "gauge",
        "updates queued on the async primary->backup replica link"),
    "ps.failovers": (
        "paddle_ps_failovers_total", "counter",
        "primary->backup promotions performed by PS clients"),
    "ps.dedup_hits": (
        "paddle_ps_dedup_hits_total", "counter",
        "retried PS pushes suppressed by (client_id, seq) dedup"),
}

#: monitor stat -> (prometheus name, type, help) for the recommender-
#: serving family (TPUEmbeddingCache + OnlineTrainer); same contract as
#: _PS_METRICS, mirrored in snapshot()["rec"] alongside the live-cache
#: gauges of _rec_gauges()
_REC_METRICS = {
    "rec.cache_hits": (
        "paddle_rec_cache_hits_total", "counter",
        "embedding-cache lookups served from resident rows"),
    "rec.cache_misses": (
        "paddle_rec_cache_misses_total", "counter",
        "embedding-cache lookups that pulled rows from the PS"),
    "rec.cache_evictions": (
        "paddle_rec_cache_evictions_total", "counter",
        "LRU evictions from embedding caches"),
    "rec.cache_invalidations": (
        "paddle_rec_cache_invalidations_total", "counter",
        "resident cache rows marked stale by applied pushes"),
    "rec.cache_refreshes": (
        "paddle_rec_cache_refreshes_total", "counter",
        "stale resident rows re-pulled before being served"),
    "rec.max_served_staleness": (
        "paddle_rec_max_served_staleness", "gauge",
        "max applied-push lag observed by any served embedding read"),
    "rec.online_steps": (
        "paddle_rec_online_steps_total", "counter",
        "click batches fed by online trainers"),
}

#: monitor stat -> (prometheus name, type, help) for the elastic-fleet
#: family (ReplicaSet membership + Autoscaler); same contract as
#: _PS_METRICS, mirrored in snapshot()["fleet"]. Scale-event counters
#: get a direction label; slo_violation_ms is converted to seconds
_FLEET_METRICS = {
    "fleet.target_replicas": (
        "paddle_fleet_target_replicas", "gauge",
        "fleet size the autoscaler is steering toward"),
    "fleet.live_replicas": (
        "paddle_fleet_live_replicas", "gauge",
        "replicas currently healthy (able to take new routes)"),
    "fleet.scale_events_up": (
        "paddle_fleet_scale_events_total", "counter",
        "fleet membership changes (labelled by direction)"),
    "fleet.scale_events_down": (
        "paddle_fleet_scale_events_total", "counter",
        "fleet membership changes (labelled by direction)"),
    "fleet.weight_version": (
        "paddle_fleet_weight_version", "gauge",
        "committed model weight version serving the fleet"),
    "fleet.rollouts": (
        "paddle_fleet_rollouts_total", "counter",
        "rolling weight upgrades committed fleet-wide"),
    "fleet.rollbacks": (
        "paddle_fleet_rollbacks_total", "counter",
        "rollouts auto-rolled-back (gate failure or operator abort)"),
}
#: fleet stats consumed by _FLEET_METRICS or converted inline — kept
#: out of the generic (counter-typed) monitor dump
_FLEET_STATS = set(_FLEET_METRICS) | {"fleet.slo_violation_ms"}

#: monitor stat -> (prometheus name, type, help) for the gang-supervised
#: training family (distributed/gang.py); same contract as _PS_METRICS,
#: mirrored in snapshot()["gang"]. restart_lost_ms is converted to
#: seconds; per-rank heartbeat ages are live gauges from the supervisor
_GANG_METRICS = {
    "gang.restarts": (
        "paddle_gang_restarts_total", "counter",
        "coordinated whole-gang restarts (a rank died or stalled)"),
    "gang.collective_timeouts": (
        "paddle_gang_collective_timeouts_total", "counter",
        "eager collectives/barriers that hit their "
        "FLAGS_dist_timeout_s deadline"),
    "gang.peer_gone": (
        "paddle_gang_peer_gone_total", "counter",
        "p2p sends/recvs that raised PeerGoneError (peer dead or "
        "unreachable within the deadline)"),
    "gang.quarantined": (
        "paddle_gang_quarantined_total", "counter",
        "flaky rank slots excluded from world re-formation"),
    "gang.commits": (
        "paddle_gang_commits_total", "counter",
        "checkpoint steps that passed the gang commit barrier "
        "(globally committed on every rank)"),
    "gang.restores": (
        "paddle_gang_restores_total", "counter",
        "rank restores from a globally committed step"),
    "gang.heartbeats": (
        "paddle_gang_heartbeats_total", "counter",
        "worker heartbeat+watermark writes into the gang registry"),
}
#: gang stats consumed by _GANG_METRICS or converted inline
_GANG_STATS = set(_GANG_METRICS) | {"gang.restart_lost_ms"}

#: monitor stats mirrored in snapshot()["mesh"] (mesh-sharded serving's
#: KV-migration traffic; the serving-registry counters of the same
#: names feed the labelled paddle_serving_mesh_* family below)
_MESH_STATS = (
    "serving.kv_migrations", "serving.kv_migrate_blocks",
    "serving.kv_migrate_bytes", "serving.kv_migrate_faults",
    "serving.kv_migrate_timeouts",
)

#: monitor stat -> (prometheus name, type, help) for the persistent SSD
#: KV tier (serving/kvstore.py); same contract as _PS_METRICS, emitted
#: ahead of the generic dump and mirrored in snapshot()["kvstore"].
#: The per-replica prefix-affinity hit rate rides with the fleet
#: section (it is a labelled gauge over the Router snapshot)
_KVSTORE_METRICS = {
    "serving.kv_spilled_blocks": (
        "paddle_serving_kvstore_spilled_blocks_total", "counter",
        "evicted KV blocks durably appended to the SSD spill tier"),
    "serving.kv_restored_blocks": (
        "paddle_serving_kvstore_restored_blocks_total", "counter",
        "KV blocks re-staged from spilled records on session resume"),
    "serving.kv_invalidated_blocks": (
        "paddle_serving_kvstore_invalidated_blocks_total", "counter",
        "spilled records fenced by weight-rollout commits"),
    "serving.kv_spill_bytes": (
        "paddle_serving_kvstore_spill_bytes_total", "counter",
        "bytes appended to the SSD KV spill tier"),
    "serving.kv_restore_corrupt": (
        "paddle_serving_kvstore_restore_corrupt_records_total",
        "counter",
        "spilled records that failed crc re-verification at restore "
        "(degraded to re-prefill, never wrong tokens)"),
    "serving.kv_restore_fenced": (
        "paddle_serving_kvstore_restore_fenced_total", "counter",
        "session resumes that hit a generation-fenced record and fell "
        "back to re-prefill on the live weights"),
    "serving.kv_spill_errors": (
        "paddle_serving_kvstore_spill_errors_total", "counter",
        "spill appends that failed (durability lost for that block; "
        "the eviction itself proceeded)"),
}

#: monitor stat -> (prometheus name, type, help) for the low-precision
#: compute family (ops/lowp.py + quantization/scaling.py); same
#: contract as _PS_METRICS, mirrored in snapshot()["lowp"]. The
#: matmuls counters carry a dtype label (one prometheus name), and the
#: clip rate is stored as an integer ppm in the monitor registry
#: (monitor stats coerce to int) and rescaled to a ratio at emission
_LOWP_METRICS = {
    "lowp.matmuls_int8": (
        "paddle_lowp_matmuls_total", "counter",
        "matmul instances quantized by the lowp scaled-matmul family, "
        "by quantized dtype (trace-time: one per compiled program)"),
    "lowp.matmuls_fp8": (
        "paddle_lowp_matmuls_total", "counter",
        "matmul instances quantized by the lowp scaled-matmul family, "
        "by quantized dtype (trace-time: one per compiled program)"),
    "lowp.scale_updates": (
        "paddle_lowp_scale_updates_total", "counter",
        "delayed-scaling recompute events absorbed by the ScaleState "
        "carry"),
    "lowp.clipped_elems": (
        "paddle_lowp_clipped_elements_total", "counter",
        "elements that saturated the quantization range under the "
        "delayed scales"),
    "lowp.quantized_elems": (
        "paddle_lowp_quantized_elements_total", "counter",
        "elements quantized under the delayed-scaling region"),
    "lowp.clip_rate_ppm": (
        "paddle_lowp_clip_rate_ppm", "gauge",
        "per-tensor clip/saturation rate of the delayed-scaling "
        "region, parts per million"),
    "lowp.amax_history_depth": (
        "paddle_lowp_amax_history_depth", "gauge",
        "length of each tensor slot's abs-max history ring "
        "(FLAGS_lowp_amax_history)"),
    "lowp.slot_overflow": (
        "paddle_lowp_slot_overflow_total", "counter",
        "matmul operands beyond the ScaleState slot capacity that "
        "fell back to dynamic scaling"),
}

def _gang():
    """`distributed.gang` (imported on use: observe is imported by the
    modules gang builds on)."""
    from ..distributed import gang

    return gang


#: disaggregation role encodings for the mesh-family role gauge
MESH_ROLE_CODES = {"any": 0, "prefill": 1, "decode": 2}


def _rec_gauges():
    """Live-cache gauges of the recommender-serving family (computed,
    not monotonic — they track the embedding caches currently alive).
    The port has no embedding cache until `rec/` and the PS are ported,
    so these are the gauges over no live cache: a hit rate of 0.0, no
    rows, no slots — the values the reference reports before any cache
    exists."""
    return {
        "paddle_rec_cache_hit_rate": (
            0.0, "lookup fraction served from resident rows (live caches)"),
        "paddle_rec_cache_size": (
            0, "resident rows across live embedding caches"),
        "paddle_rec_cache_capacity": (
            0, "total slots across live embedding caches"),
    }


def _pname(name):
    """Sanitize into a legal Prometheus metric name."""
    n = _NAME_OK.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] in "_:"):
        n = "_" + n
    return n


def _fmt(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _escape(value):
    """A label value with backslashes and double quotes escaped."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


class _Lines:
    def __init__(self):
        self.out = []
        self._typed = set()

    def add(self, name, value, mtype="gauge", labels=None, help_=None):
        name = _pname(name)
        if name not in self._typed:
            if help_:
                self.out.append(f"# HELP {name} {help_}")
            self.out.append(f"# TYPE {name} {mtype}")
            self._typed.add(name)
        lab = ""
        if labels:
            parts = ",".join(f'{_pname(k)}="{_escape(v)}"'
                             for k, v in labels.items())
            lab = "{" + parts + "}"
        self.out.append(f"{name}{lab} {_fmt(value)}")

    def text(self):
        return "\n".join(self.out) + "\n"


def prometheus_text(serving=None, queue_depth=None, fleet=None):
    """Prometheus/OpenMetrics text across monitor + timeline + goodput
    (+ one server's ServingMetrics when handling its /metrics; `fleet`
    takes a Router/ReplicaSet `snapshot()` and adds the per-replica
    state, restart, heartbeat, and breaker gauges)."""
    from ..framework import monitor

    L = _Lines()

    # durable-PS family first: stable names + correct types (the generic
    # monitor dump below would publish the gauges as counters), always
    # present even at zero so dashboards see the series from boot
    for stat, (pname, mtype, help_) in _PS_METRICS.items():
        L.add(pname, monitor.stat_get(stat), mtype=mtype, help_=help_)

    # recommender-serving family: lifetime counters + live-cache gauges
    for stat, (pname, mtype, help_) in _REC_METRICS.items():
        L.add(pname, monitor.stat_get(stat), mtype=mtype, help_=help_)
    for pname, (value, help_) in _rec_gauges().items():
        L.add(pname, value, help_=help_)

    # elastic-fleet family: autoscaler gauges + direction-labelled
    # scale-event counters + SLO error-budget burn
    for stat, (pname, mtype, help_) in _FLEET_METRICS.items():
        labels = None
        if stat.startswith("fleet.scale_events_"):
            labels = {"direction": stat.rsplit("_", 1)[1]}
        L.add(pname, monitor.stat_get(stat), mtype=mtype, labels=labels,
              help_=help_)
    L.add("paddle_fleet_slo_violation_seconds_total",
          monitor.stat_get("fleet.slo_violation_ms") / 1e3,
          mtype="counter",
          help_="cumulative seconds the windowed e2e p99 spent over "
                "FLAGS_fleet_slo_p99_ms")

    # gang-supervised training family: restart/timeout counters,
    # restart-lost seconds, and live per-rank heartbeat-age gauges
    for stat, (pname, mtype, help_) in _GANG_METRICS.items():
        L.add(pname, monitor.stat_get(stat), mtype=mtype, help_=help_)
    L.add("paddle_gang_restart_lost_seconds_total",
          monitor.stat_get("gang.restart_lost_ms") / 1e3,
          mtype="counter",
          help_="wall time lost to coordinated gang restarts "
                "(detection -> teardown -> backoff -> respawn)")
    for slot, age in sorted(_gang().heartbeat_ages().items()):
        L.add("paddle_gang_rank_heartbeat_age_seconds", age,
              labels={"rank": slot},
              help_="age of this rank's last gang heartbeat")

    # persistent-KV-tier family: spill/restore/fencing traffic of the
    # SSD tier, stable names + helps (mirrored in snapshot()["kvstore"])
    for stat, (pname, mtype, help_) in _KVSTORE_METRICS.items():
        L.add(pname, monitor.stat_get(stat), mtype=mtype, help_=help_)

    # low-precision compute family: dtype-labelled quantized-matmul
    # counters + delayed-scaling clip/update telemetry
    for stat, (pname, mtype, help_) in _LOWP_METRICS.items():
        labels = None
        if stat.startswith("lowp.matmuls_"):
            labels = {"dtype": stat.rsplit("_", 1)[1]}
        L.add(pname, monitor.stat_get(stat), mtype=mtype, labels=labels,
              help_=help_)

    for name, value in sorted(monitor.stats().items()):
        if not isinstance(value, (int, float)):
            continue
        if name in _PS_METRICS or name in _REC_METRICS \
                or name in _FLEET_STATS or name in _GANG_STATS \
                or name in _KVSTORE_METRICS or name in _LOWP_METRICS:
            continue
        L.add(f"paddle_{name}", value, mtype="counter",
              help_="framework.monitor stat")

    aggs = _timeline.aggregates()
    for phase, agg in sorted(aggs.items()):
        L.add("paddle_phase_seconds_total", agg["total_s"], mtype="counter",
              labels={"phase": phase}, help_="step timeline phase time")
        L.add("paddle_phase_calls_total", agg["calls"], mtype="counter",
              labels={"phase": phase})
        L.add("paddle_phase_max_seconds", agg["max_s"],
              labels={"phase": phase})

    gp = goodput(aggs)
    for cat, secs in sorted(gp["categories_s"].items()):
        L.add("paddle_goodput_seconds_total", secs, mtype="counter",
              labels={"category": cat},
              help_="wall time by goodput category")
    L.add("paddle_goodput_seconds_total", gp["overlapped_s"],
          mtype="counter", labels={"category": "overlapped"})
    L.add("paddle_goodput_ratio", gp["goodput"],
          help_="productive fraction of accounted wall time")

    L.add("paddle_compile_events_total", len(retrace.compile_events()),
          mtype="counter", help_="jit compilations recorded")

    if serving is not None:
        snap = serving.snapshot(queue_depth=queue_depth)
        for k, v in sorted(snap.get("counters", {}).items()):
            L.add(f"paddle_serving_{k}_total", v, mtype="counter",
                  help_="serving counter")
        L.add("paddle_serving_uptime_seconds", snap["uptime_s"],
              mtype="counter")
        L.add("paddle_serving_qps", snap["qps"])
        L.add("paddle_serving_tokens_per_second", snap["tokens_per_s"])
        occ = snap["batch_occupancy"]
        L.add("paddle_serving_batch_occupancy", occ["avg"],
              labels={"stat": "avg"},
              help_="decode slot utilisation (active/capacity)")
        L.add("paddle_serving_batch_occupancy", occ["max"],
              labels={"stat": "max"})
        for kind, stats in sorted(snap.get("latency_s", {}).items()):
            for q in ("p50", "p95", "p99", "max"):
                L.add("paddle_serving_latency_seconds", stats[q],
                      labels={"kind": kind, "quantile": q},
                      help_="serving latency quantiles (seconds)")
        blk = snap.get("kv_blocks")
        if blk:
            L.add("paddle_serving_kv_blocks_in_use", blk["in_use"],
                  help_="physical KV blocks referenced at the last step")
            L.add("paddle_serving_kv_blocks_total", blk["total"],
                  help_="usable physical KV blocks in the paged pool")
            L.add("paddle_serving_kv_block_occupancy", blk["occupancy"],
                  labels={"stat": "avg"},
                  help_="KV block-pool utilisation (in_use/total)")
            L.add("paddle_serving_kv_block_occupancy",
                  blk["occupancy_max"], labels={"stat": "max"})
        pfx = snap.get("prefix_cache")
        if pfx:
            L.add("paddle_serving_prefix_cache_hit_rate",
                  pfx["hit_rate"],
                  help_="prompt tokens served from cached KV blocks")
        cp = snap.get("chunked_prefill")
        if cp:
            L.add("paddle_serving_prefill_tokens_per_step",
                  cp["tokens_per_step"],
                  help_="prompt tokens folded into each decode step")
        # speculative decoding: the drafted/accepted/rejected counters
        # already flow through the generic counter loop above as
        # paddle_serving_spec_*_total — only the gauges are added here
        spec = snap.get("speculative")
        if spec:
            L.add("paddle_serving_spec_acceptance_rate",
                  spec["acceptance_rate"],
                  help_="accepted/drafted proposal tokens since start")
            for s, rate in sorted(spec["per_slot_acceptance"].items()):
                L.add("paddle_serving_spec_slot_acceptance_rate", rate,
                      labels={"slot": s},
                      help_="per-slot speculative acceptance rate")
            L.add("paddle_serving_spec_dequant_path",
                  spec["dequant_path"],
                  help_="1 while the engine serves int8-frozen weights "
                        "through the dequant epilogue path")
        # disaggregated serving: the reference's mesh family, shape-
        # labelled gauges + KV-migration counters + the role gauge; a
        # port engine runs on one device ("single", one shard, whose
        # occupancy is the engine's)
        mesh = snap.get("disagg")
        if mesh:
            mlab = {"mesh": "single"}
            L.add("paddle_serving_mesh_devices", 1,
                  labels=mlab,
                  help_="devices in this engine's serving mesh")
            L.add("paddle_serving_mesh_role",
                  MESH_ROLE_CODES.get(mesh["role"], -1),
                  labels={**mlab, "role": mesh["role"]},
                  help_="disaggregation role (0=any 1=prefill 2=decode)")
            L.add("paddle_serving_mesh_shard_occupancy", occ["avg"],
                  labels={**mlab, "shard": "0"},
                  help_="per-shard decode slot occupancy (GSPMD "
                        "runs one program per shard)")
            for k in ("kv_migrations", "kv_migrate_blocks",
                      "kv_migrate_bytes", "kv_migrate_faults"):
                L.add(f"paddle_serving_mesh_{k}_total", mesh[k],
                      mtype="counter", labels=mlab,
                      help_="prefill->decode KV block migration traffic")
        # multi-tenant serving: one labelled family per tenant-scoped
        # signal (qps, tokens, shed, latency quantiles, budget gauge)
        for tname, tsnap in sorted(snap.get("tenants", {}).items()):
            tlab = {"tenant": tname}
            for k, v in sorted(tsnap.get("counters", {}).items()):
                L.add(f"paddle_tenant_{k}_total", v, mtype="counter",
                      labels=tlab, help_="per-tenant serving counter")
            L.add("paddle_tenant_qps", tsnap["qps"], labels=tlab,
                  help_="completions per second billed to this tenant")
            L.add("paddle_tenant_tokens_per_second",
                  tsnap["tokens_per_s"], labels=tlab,
                  help_="generated tokens per second billed to this "
                        "tenant")
            lat = tsnap.get("latency_s")
            if lat:
                for q in ("p50", "p95", "p99", "max"):
                    L.add("paddle_tenant_latency_seconds", lat[q],
                          labels={**tlab, "quantile": q},
                          help_="per-tenant end-to-end latency "
                                "quantiles (seconds)")
            for g, v in sorted(tsnap.get("gauges", {}).items()):
                L.add(f"paddle_tenant_{g}", v, labels=tlab,
                      help_="per-tenant gauge (e.g. budget_remaining "
                            "tokens)")
    if queue_depth is not None:
        L.add("paddle_serving_queue_depth", queue_depth)

    if fleet is not None:
        from ..serving.fleet import REPLICA_STATE_CODES

        breaker_codes = {"closed": 0, "open": 1, "half-open": 2}
        for rep in fleet.get("replicas", ()):
            # model_version labels every per-replica series so a
            # mid-rollout scrape shows exactly which replicas moved
            labels = {"replica": rep["name"],
                      "model_version": str(rep.get("weight_version", 0))}
            L.add("paddle_serving_replica_model_version",
                  rep.get("weight_version", 0), labels=labels,
                  help_="weight version this replica serves (or is "
                        "rebuilding toward)")
            L.add("paddle_serving_replica_state",
                  REPLICA_STATE_CODES.get(rep["state"], -1),
                  labels={**labels, "state": rep["state"]},
                  help_="replica lifecycle state (0=starting 1=healthy "
                        "2=dead 3=backoff 4=stopped 5=draining)")
            L.add("paddle_serving_replica_restarts", rep["restarts"],
                  mtype="counter", labels=labels,
                  help_="supervised restarts of this replica")
            L.add("paddle_serving_replica_deaths", rep["deaths"],
                  mtype="counter", labels=labels)
            L.add("paddle_serving_replica_heartbeats", rep["heartbeats"],
                  mtype="counter", labels=labels,
                  help_="engine loop iterations (liveness beats)")
            L.add("paddle_serving_replica_load", rep["load"],
                  labels=labels,
                  help_="router-visible in-flight attempts")
            if "uptime_s" in rep:
                L.add("paddle_serving_replica_uptime_seconds",
                      rep["uptime_s"], labels=labels,
                      help_="seconds since this replica's engine built")
            if "beat_age_s" in rep:
                L.add("paddle_serving_replica_beat_age_seconds",
                      rep["beat_age_s"], labels=labels,
                      help_="age of the replica's last liveness beat")
            role = rep.get("role", "any")
            L.add("paddle_serving_replica_role",
                  MESH_ROLE_CODES.get(role, -1),
                  labels={**labels, "role": role,
                          "mesh": rep.get("mesh", "") or "single"},
                  help_="replica disaggregation role "
                        "(0=any 1=prefill 2=decode)")
            br = rep.get("breaker", {})
            L.add("paddle_serving_replica_breaker_state",
                  breaker_codes.get(br.get("state"), -1),
                  labels={**labels, "state": br.get("state", "?")},
                  help_="circuit breaker (0=closed 1=open 2=half-open)")
        if "brownout" in fleet:
            L.add("paddle_serving_brownout_active", fleet["brownout"],
                  help_="fleet brownout (load shedding) engaged")
        if "in_flight" in fleet:
            L.add("paddle_serving_fleet_in_flight", fleet["in_flight"],
                  help_="client requests the Router is tracking")
        aff = fleet.get("affinity")
        if aff:
            L.add("paddle_serving_kvstore_affinity_lookups_total",
                  aff["lookups"], mtype="counter",
                  help_="prefix-affinity routing decisions attempted")
            L.add("paddle_serving_kvstore_affinity_hits_total",
                  aff["hits"], mtype="counter",
                  help_="dispatches steered to the replica holding the "
                        "longest live prefix match")
            L.add("paddle_serving_kvstore_affinity_hit_rate",
                  aff["hit_rate"],
                  help_="fleet-wide sticky-affinity hit fraction")
            for rname, per in sorted(aff.get("per_replica", {}).items()):
                L.add("paddle_serving_kvstore_replica_affinity_hits",
                      per["hits"], mtype="counter",
                      labels={"replica": rname},
                      help_="affinity-steered dispatches per replica")
                L.add(
                    "paddle_serving_kvstore_replica_prefix_hit_rate",
                    per["prefix_hit_rate"], labels={"replica": rname},
                    help_="this replica's own prompt-token prefix-cache "
                          "hit rate")

    return L.text()
