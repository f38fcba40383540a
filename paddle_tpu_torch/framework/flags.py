"""Runtime flags registry: set_flags / get_flags + FLAGS_* env.

The serving subset of paddle_tpu's registry (the engine's, the
fleet's, the rollout's and tenancy's flags) plus the ERNIE head's
`FLAGS_use_fused_lm_loss`, the ResNet convs' `FLAGS_use_pallas_conv`,
the low-precision training flags (`FLAGS_lowp_*`), and those of the
anomaly guard's rollback, checkpointing, simulated preemption, the
flight recorder and `FLAGS_remat_policy`, and the gang's deadlines and
supervisor (`FLAGS_dist_timeout_s`, `FLAGS_gang_*`), with the same names
and defaults. Unknown flags
raise.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()

# name -> (default, type, doc)
_DEFS = {
    "FLAGS_serving_max_batch": (
        8, int,
        "serving: slot-pool size of the continuous-batching decode "
        "engine"),
    "FLAGS_serving_queue_cap": (
        64, int,
        "serving: bounded admission-queue capacity; submissions beyond "
        "it are shed immediately with QueueFullError (429-style)"),
    "FLAGS_serving_default_timeout_s": (
        30.0, float,
        "serving: default per-request deadline in seconds (0 = none); "
        "expired requests fail with DeadlineExceededError whether "
        "queued or mid-decode"),
    "FLAGS_serving_kv_block_size": (
        16, int,
        "serving: tokens per physical KV block of the paged cache; a "
        "request holds ceil((prompt+max_new)/block_size) blocks"),
    "FLAGS_serving_kv_blocks": (
        0, int,
        "serving: physical KV blocks in the pool (incl. reserved null "
        "block 0); 0 = auto-size to the dense-equivalent worst case "
        "max_slots*ceil(max_seq/block_size)+1"),
    "FLAGS_serving_prefill_chunk": (
        16, int,
        "serving: max prompt tokens a prefilling slot contributes to "
        "one unified decode step (chunked prefill)"),
    "FLAGS_serving_prefix_cache": (
        True, bool,
        "serving: index finished sequences' KV blocks by cumulative "
        "token-prefix hash so later requests sharing a prefix reuse "
        "physical blocks, with copy-on-write on divergence"),
    "FLAGS_serving_spec_len": (
        0, int,
        "serving: speculative-decoding draft length k — each decode "
        "round proposes up to k tokens from the draft model and "
        "verifies them in one unified step (the draft step is k+1 "
        "columns wide, verify rides the decode step). 0 disables "
        "speculation; the engine then builds no draft pools at all"),
    "FLAGS_serving_quantize": (
        False, bool,
        "serving: freeze 2-D float weights to int8 with per-tensor "
        "abs-max scales at engine build; each step dequantizes them and "
        "the tied LM head runs the dequant-matmul kernel from "
        "ops/quant_ops.py"),
    "FLAGS_serving_w8a8": (
        False, bool,
        "serving: extend the weights-only int8 decode "
        "(FLAGS_serving_quantize) to w8a8 — the tied LM-head matmul "
        "also quantizes its activation rows to int8 against a frozen "
        "per-tensor scale calibrated during warmup and the first steps "
        "(ops/lowp.py). Requires the int8-frozen tied head; ignored "
        "otherwise"),
    "FLAGS_serving_max_adapters": (
        0, int,
        "serving: capacity of the engine's stacked LoRA adapter bank "
        "([n, r, H] / [n, V, r] device tensors of the decode step; each "
        "slot gathers its own adapter row by index). Row 0 is the base "
        "model (all-zero). 0 disables adapters and keeps every existing "
        "path byte-identical"),
    "FLAGS_serving_lora_rank": (
        8, int,
        "serving: low-rank dimension r of the batched LoRA adapter "
        "bank (used only when FLAGS_serving_max_adapters > 0)"),
    "FLAGS_serving_kv_spill_dir": (
        "", str,
        "serving: directory for the persistent SSD KV spill tier — "
        "cold KV blocks evicted from the radix prefix cache append "
        "their payloads here (crc32-framed, append-before-evict) and "
        "restore on session resume through the all-or-nothing "
        "admission path. Empty = spill tier disabled"),
    "FLAGS_serving_kv_spill_cap_mb": (
        256, int,
        "serving: soft cap in MiB on a spill file; crossing it triggers "
        "a tmp+rename compaction that drops invalidated and superseded "
        "records (0 = never compact on size)"),
    "FLAGS_tenant_default_budget": (
        0, int,
        "serving: default per-tenant token budget in tokens/second "
        "(token bucket, lazily refilled) for tenants the directory "
        "auto-creates; over-budget admissions shed with a 429 whose "
        "Retry-After derives from the bucket's refill. 0 = unlimited"),
    "FLAGS_tenant_wfq_quantum": (
        256, int,
        "serving: deficit-round-robin quantum in tokens credited to a "
        "tenant's queue per scheduler visit; a tenant's effective "
        "share is quantum * weight (TenantFairQueue)"),
    "FLAGS_serving_prefix_affinity": (
        True, bool,
        "serving: route each request to the fleet replica holding the "
        "longest live prefix-cache match for its token prefix (sticky "
        "session affinity with clean failover when the affine replica "
        "is dead, draining, or breaker-open); False = pure "
        "least-loaded placement"),
    "FLAGS_serving_disagg": (
        False, bool,
        "serving: disaggregate prefill and decode — the Router sends "
        "each request's prefill to a prefill-role replica, streams the "
        "finished KV blocks to a decode-role replica over the "
        "deadline-guarded migration mailbox, and pins the decode leg "
        "to the prefill leg's weight version"),
    "FLAGS_fleet_min_replicas": (
        1, int,
        "fleet: autoscaler floor — the Autoscaler never drains the "
        "membership below this many replicas"),
    "FLAGS_fleet_max_replicas": (
        8, int,
        "fleet: autoscaler ceiling — add_replica stops here even if "
        "the SLO error budget is still burning"),
    "FLAGS_fleet_scale_cooldown_s": (
        5.0, float,
        "fleet: hysteresis cooldown between autoscaler actions; an "
        "overload must also persist this long before a scale-up, and "
        "idleness before a scale-down (prevents flapping)"),
    "FLAGS_fleet_slo_p99_ms": (
        500.0, float,
        "fleet: the e2e latency SLO in milliseconds; the autoscaler "
        "treats windowed p99 above this as error-budget burn and "
        "accrues fleet.slo_violation_ms while it lasts"),
    "FLAGS_rollout_canary_secs": (
        2.0, float,
        "rollout: how long the canary replica must hold the SLO burn "
        "gate (windowed e2e p99 under FLAGS_fleet_slo_p99_ms) before "
        "the staged waves start; also the default wave sustain period"),
    "FLAGS_rollout_wave_size": (
        1, int,
        "rollout: replicas upgraded per wave after the canary passes; "
        "within a wave replicas still drain->rebuild one at a time so "
        "serving capacity never drops by more than one replica"),
    "FLAGS_rollout_golden_prompts": (
        4, int,
        "rollout: number of pinned golden prompts synthesized (seeded, "
        "deterministic) for the canary bitwise gate when the caller "
        "does not supply an explicit prompt set"),
    "FLAGS_lowp_matmul": (
        "off", str,
        "low precision: route eligible matmuls (nn.Linear, the fused "
        "LM-head loss chunks) through the ops/lowp.py scaled-matmul "
        "family (kernel B9 on CUDA). 'int8' quantizes operands "
        "per-tensor to int8 with int32 accumulation; 'fp8' to e4m3 with "
        "f32 accumulation; 'off' keeps every path bitwise-unchanged. "
        "Backward always runs in bf16 (lowp forward, high-precision "
        "backward). Single-card Engine only: the mp layers, the "
        "overlap ring and the hybrid tied head are not ported"),
    "FLAGS_lowp_amax_history": (
        16, int,
        "low precision: length H of each tensor slot's abs-max history "
        "ring in quantization.scaling.ScaleState — the delayed scale is "
        "max over the ring, so a transient outlier keeps its headroom "
        "for H steps (fp8-recipe amax_history_len)"),
    "FLAGS_lowp_amax_margin": (
        0, int,
        "low precision: power-of-two headroom M added to the delayed "
        "scale (scale = ring-max * 2**M); >0 trades resolution for "
        "fewer clipped outliers between scale updates"),
    "FLAGS_lowp_scale_interval": (
        1, int,
        "low precision: recompute the delayed scales from the amax "
        "history every N steps (1 = every step); between updates the "
        "stale scale keeps the step free of any host sync"),
    "FLAGS_lowp_slots": (
        128, int,
        "low precision: per-tensor slot capacity of the ScaleState "
        "carried through the train step; call sites beyond the "
        "capacity fall back to dynamic (current-step abs-max) scaling "
        "with a one-time warning"),
    "FLAGS_use_pallas_conv": (
        True, bool,
        "route eligible convs through the fused-conv kernel B10 "
        "(ops/fused_conv.py; CPU tensors take its plain version); off = "
        "the reference's lax path, torch's convolution"),
    "FLAGS_use_fused_lm_loss": (
        True, bool,
        "route the tied-decoder matmul + cross_entropy of the ERNIE/BERT "
        "pretraining head through the fused chunked-vocab loss "
        "(ops/fused_loss.py, kernels B4-B6) that never materializes the "
        "[N, V] logits; off = the plain tied matmul_v2 + cross_entropy"),
    "FLAGS_anomaly_check_interval": (
        16, int,
        "anomaly guard: read the on-device bad-step counter back to the "
        "host only every N steps (1 = every step). The guard still "
        "skips every bad update immediately on the device; the interval "
        "only delays the host-side rollback decision by up to N-1 steps "
        "in exchange for not blocking dispatch on a device sync per "
        "step"),
    "FLAGS_anomaly_max_bad_steps": (
        3, int,
        "anomaly guard: after this many CONSECUTIVE non-finite steps "
        "(loss or grads), roll the engine back to the last good "
        "checkpoint (0 disables rollback; bad steps are still skipped "
        "on the device)"),
    "FLAGS_ckpt_verify_checksums": (
        True, bool,
        "verify the per-leaf sha256 manifest when restoring a "
        "checkpoint (detects truncated/corrupted leaves)"),
    "FLAGS_dist_timeout_s": (
        60.0, float,
        "distributed: per-call deadline (seconds) for eager collectives, "
        "barriers and the gang checkpoint commit barrier. A peer that "
        "does not answer within the deadline raises typed retriable "
        "CollectiveTimeoutError/PeerGoneError instead of blocking the "
        "rank forever (0 disables: the transport's own blocking)"),
    "FLAGS_gang_max_restarts": (
        3, int,
        "gang supervisor: coordinated gang restarts allowed before the "
        "job fails with the last rank's exit code (each restart tears "
        "down ALL ranks and re-forms the world from the newest "
        "globally committed checkpoint)"),
    "FLAGS_gang_hang_secs": (
        30.0, float,
        "gang supervisor: a rank whose heartbeat or step-progress "
        "watermark stalls this long (while its process is still alive) "
        "is declared hung and the whole gang is restarted (0 disables "
        "hang detection; keep this above FLAGS_dist_timeout_s so "
        "collective-blocked victims unblock via their deadline and the "
        "stall is attributed to the rank that actually died)"),
    "FLAGS_simulate_preempt_at_step": (
        0, int,
        "testing: report a preemption at the Nth preemption poll "
        "(step/epoch boundary); 0 disables"),
    "FLAGS_remat_policy": (
        "auto", str,
        "rematerialisation policy of recompute() segments: 'full' keeps "
        "nothing inside the segment (torch.utils.checkpoint; most "
        "recompute, least memory), 'dots_saveable' keeps the outputs of "
        "aten mm / addmm / bmm and recomputes the rest (selective "
        "checkpointing), 'none' disables it (all activations kept, no "
        "recompute), 'auto' keeps each site's default (recompute() "
        "segments recompute fully)"),
    "FLAGS_flight_recorder_capacity": (
        256, int,
        "observe: ring-buffer size of the always-on flight recorder "
        "(last N per-step records kept for the crash black box)"),
    "FLAGS_flight_recorder_dir": (
        "", str,
        "observe: directory the flight recorder dumps its JSON black "
        "box into on crash/preemption/SIGTERM (empty = system tempdir)"),
    "FLAGS_record_grad_norm": (
        False, bool,
        "observe: have the train step also keep the global gradient "
        "norm (pre-clip) as a device scalar in a reserved engine buffer "
        "so the flight recorder can log it without a host sync"),
    "FLAGS_flight_record_memory": (
        True, bool,
        "observe: include the device's bytes in use in each "
        "flight-recorder step record (torch.cuda.memory_allocated, a "
        "host counter read)"),
    "FLAGS_mp_overlap": (
        False, bool,
        "distributed: the ring collective-matmul of ops/overlap.py; not "
        "ported (ROADMAP queue A item 4): the meshed engines raise while "
        "it is on"),
}

_values: dict = {}


def _coerce(value, typ):
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return typ(value)


def _init():
    if _values:  # lock-free fast path (dict fill is atomic under the GIL)
        return
    with _lock:
        if _values:
            return
        staged = {}
        for name, (default, typ, _doc) in _DEFS.items():
            env = os.environ.get(name)
            staged[name] = _coerce(env, typ) if env is not None \
                else default
        _values.update(staged)


def set_flags(flags: dict):
    """set_flags({'FLAGS_serving_quantize': True})."""
    _init()
    for name, value in flags.items():
        if name not in _DEFS:
            raise ValueError(
                f"unknown flag {name!r}; known flags: {sorted(_DEFS)}")
        _values[name] = _coerce(value, _DEFS[name][1])


def get_flags(flags):
    """get_flags('FLAGS_x') / ['FLAGS_x', ...] -> dict."""
    _init()
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for name in flags:
        if name not in _DEFS:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = _values[name]
    return out


def flag(name):
    """Fast internal read."""
    _init()
    return _values[name]
