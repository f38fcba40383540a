"""Runtime flags registry: set_flags / get_flags + FLAGS_* env.

The serving subset of paddle_tpu's registry, with the same names and
defaults. Unknown flags raise.
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
