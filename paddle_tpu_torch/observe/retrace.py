"""Retrace audit: a global registry of every "compile" the runtime takes
(counterpart of paddle_tpu/observe/retrace.py).

PyTorch runs eagerly, so nothing is traced; what the port counts as a
compile is the first call of a step function at a new (shape, dtype)
signature — where the reference's jit traces and compiles a program.
A shape that drifts step to step is a new signature every step, which
in the port means a new set of kernel configurations, allocator
buckets and cuBLAS heuristics each step. The engines call
`record_compile(name, signature=...)` once per new signature, before
the step touches any state; `annotate(name, ...)` backfills the first
call's wall time.

`no_retrace()` turns the audit into a tripwire: any compile recorded
inside the context (beyond an allow-list) raises `RetraceError` with
the offending signature, which is how the steady-state "3 steps, 1
compile" contract is pinned. `suppress()` mutes recording for a
deliberate re-run of a known step."""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["RetraceError", "record_compile", "annotate", "compile_events",
           "signature_of", "no_retrace", "suppress", "reset"]


class RetraceError(RuntimeError):
    """An unexpected recompilation happened inside `no_retrace()`."""


_lock = threading.Lock()
_events: list = []          # [{name, signature, time, wall_s?, peak_bytes?}]
_guards: list = []          # stack of active no_retrace allow-lists
_suppressed = 0             # >0: record_compile is a no-op


def _leaves(tree, out):
    """Leaves of nested dicts (sorted keys) / lists / tuples, None
    dropped — the order and leaves jax.tree_util.tree_leaves gives."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).rpartition(".")[2]     # torch.float32 -> float32
    return getattr(dtype, "name", dtype)


def signature_of(*args):
    """Abstract (shape, dtype) signature of the tensor / array leaves of
    `args`, e.g. ``(float32[8, 64], int32[8])``."""
    leaves: list = []
    _leaves(args, leaves)
    sig = []
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None:
            sig.append(repr(leaf))
        else:
            sig.append(f"{_dtype_name(dtype)}{list(shape)}")
    return "(" + ", ".join(sig) + ")"


def record_compile(name, *args, signature=None):
    """Log one compilation: the first call of `name` at a new signature.

    Raises RetraceError when a `no_retrace()` guard is active and
    `name` is not on its allow-list."""
    if signature is None:
        signature = signature_of(*args)
    with _lock:
        if _suppressed:
            return
        ev = {"name": name, "signature": signature, "time": time.time()}
        _events.append(ev)
        if len(_events) > 4096:
            del _events[:-4096]
        guard = _guards[-1] if _guards else None
    if guard is not None and name not in guard:
        raise RetraceError(
            f"unexpected recompilation of {name!r} with signature "
            f"{signature} inside no_retrace() — steady-state step shapes "
            f"changed (pad batches / bucket sequence lengths)")


def annotate(name, wall_s=None, peak_bytes=None):
    """Attach wall time / memory peak to the most recent `name` event."""
    with _lock:
        for ev in reversed(_events):
            if ev["name"] == name:
                if wall_s is not None:
                    ev["wall_s"] = wall_s
                if peak_bytes is not None:
                    ev["peak_bytes"] = int(peak_bytes)
                return


def compile_events(name=None):
    with _lock:
        return [dict(e) for e in _events
                if name is None or e["name"] == name]


@contextlib.contextmanager
def no_retrace(allow=()):
    """Raise RetraceError on any compile recorded inside the context."""
    allow = frozenset(allow)
    with _lock:
        _guards.append(allow)
    try:
        yield
    finally:
        with _lock:
            _guards.pop()


@contextlib.contextmanager
def suppress():
    """Mute the audit for a deliberate re-run (no event, no guard
    trip)."""
    global _suppressed
    with _lock:
        _suppressed += 1
    try:
        yield
    finally:
        with _lock:
            _suppressed -= 1


def reset():
    global _suppressed
    with _lock:
        _events.clear()
        _guards.clear()
        _suppressed = 0
