"""Named stat registry (ref paddle/fluid/platform/monitor.h:77 — the
STAT_ADD int64 counters). Host-side, thread-safe; exported for
user/runtime instrumentation."""

from __future__ import annotations

import threading

_lock = threading.Lock()
_stats: dict = {}


def stat_add(name: str, value: int = 1):
    """STAT_ADD analogue (monitor.h:130)."""
    with _lock:
        _stats[name] = _stats.get(name, 0) + int(value)


def stat_set(name: str, value: int):
    with _lock:
        _stats[name] = int(value)


def stat_get(name: str) -> int:
    with _lock:
        return _stats.get(name, 0)


def stat_max(name: str, value: int):
    """Record a high-watermark. A missing key is seeded with the
    OBSERVED value (not 0) so the first negative watermark is kept."""
    v = int(value)
    with _lock:
        cur = _stats.get(name)
        _stats[name] = v if cur is None else max(cur, v)


def stat_min(name: str, value: int):
    """Record a floor-watermark (the stat_max mirror)."""
    v = int(value)
    with _lock:
        cur = _stats.get(name)
        _stats[name] = v if cur is None else min(cur, v)


def stats(prefix: str = None) -> dict:
    """All counters, or only those whose name starts with `prefix`."""
    with _lock:
        if prefix is None:
            return dict(_stats)
        return {k: v for k, v in _stats.items() if k.startswith(prefix)}


def reset():
    with _lock:
        _stats.clear()
