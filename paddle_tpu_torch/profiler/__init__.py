"""Profiler: host-side event recording + device trace capture
(counterpart of paddle_tpu/profiler, with the same names).

Ref parity: paddle/fluid/platform/profiler.h (RecordEvent RAII, event
aggregation), platform/device_tracer.cc (CUPTI device tracing),
python/paddle/fluid/profiler.py:190 (profiler context + summary table),
tools/timeline.py (chrome-trace export). PyTorch mapping:

- RecordEvent           -> host wall-clock spans (thread-aware), opening
                           a `torch.profiler.record_function` of the
                           same name while a torch profiler runs, so
                           spans land in its traces
- DeviceTracer/CUPTI    -> `start_trace` / `stop_trace`: a
                           `torch.profiler.profile` (CPU + CUDA
                           activities, CUPTI underneath) whose capture
                           is written into `logdir` as chrome-trace JSON
- profiler.profiler ctx -> profiler.profile(...)
- tools/timeline.py     -> export_chrome_tracing(path) from host events
- op-time table         -> summary(): per-op totals/avg/max/min; under
                           `profile(op_detail=True)` a CPU-activity
                           torch profiler runs and, at exit, its
                           outermost ``aten::`` ops become "op" events
                           (the port has no dispatch layer of its own)

`device_op_table` / `device_op_events` read a capture's device rows:
CUDA kernels, memsets and device-to-device copies (host<->device copies
are left out, as the reference leaves out its transfers). A CUDA
capture without a kernel row raises; only a capture taken with
``device="cpu"`` counts CPU op rows, the outermost ``aten::`` op of each
thread.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import threading
import time

import torch

__all__ = [
    "RecordEvent", "RecordMemEvent", "enable_op_profiling",
    "disable_op_profiling", "is_op_profiling_enabled", "reset", "events",
    "mem_events", "record_device_memory", "summary", "percentiles",
    "export_chrome_tracing", "profile", "start_trace", "stop_trace",
    "device_op_table", "device_op_events",
]

# rolling windows: the always-on step timeline (observe.phase) records a
# handful of spans per train/decode step, so an unbounded list would
# leak over a long run — keep the newest spans only
_MAX_EVENTS = 100_000
_MAX_MEM_EVENTS = 10_000

_lock = threading.Lock()
_events: collections.deque = collections.deque(maxlen=_MAX_EVENTS)
_op_profiling = False
_tls = threading.local()


def _now_us():
    return time.perf_counter_ns() / 1000.0


class RecordEvent:
    """Named host-side span (ref platform/profiler.h RecordEvent).

    Context manager; nests. While a torch profiler runs it also opens a
    `torch.profiler.record_function` of the same name, so the span
    appears in that profiler's trace; otherwise it costs two clock reads
    and a deque append."""

    def __init__(self, name, cat="host"):
        self.name = name
        self.cat = cat
        self._t0 = None
        self._rf = None

    def __enter__(self):
        depth = getattr(_tls, "depth", 0)
        _tls.depth = depth + 1
        self._t0 = _now_us()
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        dur = _now_us() - self._t0
        _tls.depth -= 1
        with _lock:
            _events.append({
                "name": self.name, "cat": self.cat, "ts": self._t0,
                "dur": dur, "tid": threading.get_ident(),
                "depth": _tls.depth,
            })
        return False


_mem_events: collections.deque = collections.deque(maxlen=_MAX_MEM_EVENTS)


class RecordMemEvent:
    """Memory event (ref platform/profiler.proto:38 MemEvent): a named
    allocation/deallocation or snapshot with byte counts and place.
    Usable directly (`RecordMemEvent("alloc", bytes=..., place=...)`)
    or via record_device_memory() snapshots."""

    def __init__(self, annotation, *, bytes=0, place=None, kind="alloc",
                 extra=None):
        ev = {
            "annotation": annotation, "kind": kind,
            "bytes": int(bytes), "place": str(place or "device:0"),
            "ts": _now_us(), "tid": threading.get_ident(),
        }
        if extra:
            ev.update(extra)
        with _lock:
            _mem_events.append(ev)


def record_device_memory(annotation="snapshot", device=None):
    """Snapshot the card's MEASURED memory as a MemEvent and roll the
    high-watermark into framework.monitor (STAT_ADD analogue of the
    reference's GPU mem stat). On a card the caching allocator's
    ``allocated_bytes.all.current`` stands for ``bytes_in_use`` and its
    ``.peak`` for ``peak_bytes_in_use``; a CPU device has no device
    memory to read and reports 0 in use, no peak. Returns those stats
    under the reference's keys."""
    from .. import resolve_device
    from ..framework import monitor

    dev = resolve_device(device)
    stats = {"bytes_in_use": 0, "peak_bytes_in_use": -1,
             "host_bytes_in_use": 0}
    if dev.type == "cuda":
        raw = torch.cuda.memory_stats(dev)
        stats["bytes_in_use"] = int(raw.get("allocated_bytes.all.current",
                                            0))
        stats["peak_bytes_in_use"] = int(raw.get("allocated_bytes.all.peak",
                                                 -1))
    in_use, peak = stats["bytes_in_use"], stats["peak_bytes_in_use"]
    RecordMemEvent(annotation, bytes=in_use, kind="snapshot",
                   place="device", extra={
                       "peak_bytes_in_use": peak,
                       "host_bytes_in_use": stats["host_bytes_in_use"],
                   })
    monitor.stat_max("device_mem_bytes_in_use_peak",
                     peak if peak >= 0 else in_use)
    return stats


def reset():
    with _lock:
        _events.clear()
        _mem_events.clear()


def events():
    with _lock:
        return list(_events)


def mem_events():
    with _lock:
        return list(_mem_events)


def enable_op_profiling():
    """Turn op profiling on (ref imperative/profiler.cc): engines then
    snapshot device memory each step; `profile(op_detail=True)` also
    records the torch ops it saw as "op" events."""
    global _op_profiling
    _op_profiling = True


def disable_op_profiling():
    global _op_profiling
    _op_profiling = False


def is_op_profiling_enabled():
    return _op_profiling


# -- torch.profiler captures -------------------------------------------------

_capture = None          # the running capture: dict(prof, logdir, kind, t0)
_capture_ids = itertools.count()


# empty kernels that open each CUDA capture (see _start_capture)
WARMUP_SPINS = 32
_SPIN = "spin_kernel"


def _start_capture(kind, logdir):
    global _capture
    from torch.profiler import ProfilerActivity

    if _capture is not None:
        raise RuntimeError("a profiler capture is already running")
    acts = [ProfilerActivity.CPU]
    if kind == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    t0 = _now_us()
    prof.start()
    if kind == "cuda":
        # in a long process on the card the first 7-12 kernel launches of
        # a capture were seen to leave no kernel record (their runtime
        # launch events present): the window opens with WARMUP_SPINS
        # empty spin kernels, which take that loss and which the readers
        # below do not count
        torch.cuda.synchronize()
        for _ in range(WARMUP_SPINS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    _capture = {"prof": prof, "logdir": logdir, "kind": kind, "t0": t0}


def _stop_capture():
    """Stop the running capture; export it when it has a logdir (the
    path is returned) and, under op profiling, fold its outermost aten
    ops into the host events."""
    global _capture
    cap, _capture = _capture, None
    if cap is None:
        raise RuntimeError("no profiler capture is running")
    prof = cap["prof"]
    prof.stop()
    path = None
    if cap["logdir"] is not None:
        os.makedirs(cap["logdir"], exist_ok=True)
        path = os.path.join(
            cap["logdir"],
            f"capture-{os.getpid()}-{next(_capture_ids)}."
            f"{cap['kind']}.trace.json")
        prof.export_chrome_trace(path)
    if _op_profiling:
        _fold_ops(prof, cap["t0"])
    return path


def _outermost_aten(evs):
    """Torch function events named aten::*, keeping only those with no
    aten:: ancestor (an aten op's nested calls would count twice)."""
    out = []
    for e in evs:
        if not e.name.startswith("aten::"):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("aten::"):
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return out


def _fold_ops(prof, t0):
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    with _lock:
        for e in _outermost_aten(cpu):
            _events.append({
                "name": e.name, "cat": "op",
                "ts": t0 + e.time_range.start,
                "dur": e.time_range.elapsed_us(), "tid": e.thread,
                "depth": 0,
            })


@contextlib.contextmanager
def profile(*, op_detail=True, trace_dir=None, device=None):
    """Profiler scope (ref fluid/profiler.py:257 profiler ctx).

    op_detail: record the torch ops run inside as "op" events for
    summary(). trace_dir: also capture a device trace there
    (`start_trace`, on `device`)."""
    reset()
    if op_detail:
        enable_op_profiling()
    if trace_dir:
        start_trace(trace_dir, device=device)
    elif op_detail:
        _start_capture("cpu", None)
    try:
        yield
    finally:
        try:
            if trace_dir or op_detail:
                _stop_capture()
        finally:
            if op_detail:
                disable_op_profiling()


def summary(sorted_by="total", limit=None):
    """Aggregate events by name into the reference's op-time table
    (fluid/profiler.py:190 print_profiler). Returns the table string."""
    agg: dict[str, list[float]] = {}
    for e in events():
        agg.setdefault(e["name"], []).append(e["dur"])
    rows = []
    for name, durs in agg.items():
        rows.append({
            "name": name, "calls": len(durs), "total": sum(durs),
            "avg": sum(durs) / len(durs), "max": max(durs),
            "min": min(durs),
        })
    key = {"total": "total", "calls": "calls", "avg": "avg",
           "max": "max", "min": "min"}.get(sorted_by, "total")
    rows.sort(key=lambda r: r[key], reverse=True)
    if limit:
        rows = rows[:limit]
    lines = [
        f"{'Event':<40}{'Calls':>8}{'Total(us)':>14}{'Avg(us)':>12}"
        f"{'Max(us)':>12}{'Min(us)':>12}"
    ]
    lines.append("-" * len(lines[0]))
    for r in rows:
        lines.append(
            f"{r['name'][:39]:<40}{r['calls']:>8}{r['total']:>14.1f}"
            f"{r['avg']:>12.1f}{r['max']:>12.1f}{r['min']:>12.1f}")
    mems = mem_events()
    if mems:
        # device-memory section (ref fluid/profiler.py mem table /
        # profiler.proto MemEvent): measured snapshots, peak first
        lines.append("")
        lines.append("Device memory (measured)")
        lines.append(f"{'Annotation':<32}{'Kind':>10}{'Bytes':>16}"
                     f"{'Peak':>16}{'HostBytes':>14}")
        lines.append("-" * 88)
        peak_all = max((m.get("peak_bytes_in_use", -1) for m in mems),
                       default=-1)
        in_use_max = max((m["bytes"] for m in mems), default=0)
        host_max = max((m.get("host_bytes_in_use", 0) for m in mems),
                       default=0)
        for m in mems[-20:]:
            lines.append(
                f"{m['annotation'][:31]:<32}{m['kind']:>10}"
                f"{m['bytes']:>16}"
                f"{m.get('peak_bytes_in_use', -1):>16}"
                f"{m.get('host_bytes_in_use', 0):>14}")
        lines.append(
            f"{'== high watermark ==':<32}{'':>10}{in_use_max:>16}"
            f"{peak_all:>16}{host_max:>14}")
    return "\n".join(lines)


def percentiles(name, ps=(50, 95, 99)):
    """Latency percentiles (microseconds) over the recorded host spans
    named `name` — {p: duration_us} with linear interpolation (numpy's
    'linear' method)."""
    from ..utils import stats as _stats

    durs = [e["dur"] for e in events() if e["name"] == name]
    if not durs:
        raise ValueError(f"no recorded events named {name!r}")
    return _stats.percentiles(durs, ps)


def export_chrome_tracing(path):
    """Write host events as a chrome://tracing JSON file
    (ref tools/timeline.py).

    Spans are sorted by start time and carry their recorded nesting
    `depth` (spans land in `_events` at EXIT, so inner spans precede
    their parents in recording order — the sort restores enclosure
    order so chrome stacks nested spans correctly). Memory events are
    emitted as counter (``ph:"C"``) rows so the measured
    bytes-in-use/peak series renders as a track under the spans."""
    pid = os.getpid()
    trace_events = [
        {
            "name": e["name"], "cat": e["cat"], "ph": "X",
            "ts": e["ts"], "dur": e["dur"], "pid": pid,
            "tid": e["tid"], "args": {"depth": e.get("depth", 0)},
        }
        for e in sorted(events(), key=lambda e: (e["tid"], e["ts"]))
    ]
    for m in mem_events():
        args = {"bytes_in_use": m["bytes"]}
        if "host_bytes_in_use" in m:
            args["host_bytes_in_use"] = m["host_bytes_in_use"]
        if m.get("peak_bytes_in_use", -1) >= 0:
            args["peak_bytes_in_use"] = m["peak_bytes_in_use"]
        trace_events.append({
            "name": f"memory ({m['place']})", "cat": "memory", "ph": "C",
            "ts": m["ts"], "pid": pid, "tid": 0, "args": args,
        })
    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


# -- device trace ------------------------------------------------------------


def start_trace(logdir, device=None):
    """Start a device-trace capture (ref device_tracer.cc): a
    `torch.profiler.profile` with the CPU and, on a card, the CUDA
    activity (CUPTI), opened by `WARMUP_SPINS` empty spin kernels that
    the readers do not count. `device` (default cuda) decides which rows
    the capture's readers count; `stop_trace` writes it into `logdir`."""
    from .. import resolve_device

    _start_capture(resolve_device(device).type, os.path.abspath(logdir))


def stop_trace():
    """Stop the capture and write it into its logdir as the chrome-trace
    JSON torch exports (``capture-*.<device>.trace.json``); returns the
    file's path."""
    return _stop_capture()


def _capture_paths(logdir):
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.trace.json"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.trace.json under {logdir}")
    return paths


def _device_rows(path):
    """[(name, line, start_us, dur_us)] of one capture's counted rows."""
    with open(path) as f:
        evs = [e for e in json.load(f).get("traceEvents", ())
               if e.get("ph") == "X" and "dur" in e]
    if path.endswith(".cpu.trace.json"):
        ops = sorted((e for e in evs if e.get("cat") == "cpu_op"
                      and e["name"].startswith("aten::")),
                     key=lambda e: (str(e.get("tid")), e["ts"], -e["dur"]))
        out, tid, end = [], None, float("-inf")
        for e in ops:
            if e.get("tid") != tid:
                tid, end = e.get("tid"), float("-inf")
            if e["ts"] < end:
                continue            # inside an outer aten op
            end = e["ts"] + e["dur"]
            out.append((e["name"], f"thread {tid}", float(e["ts"]),
                        float(e["dur"])))
        return out
    out, kernels = [], 0
    for e in evs:
        cat = e.get("cat")
        if cat == "kernel":
            if e["name"].startswith(_SPIN):
                continue            # the capture's own warm-up launches
            kernels += 1
        elif not (cat == "gpu_memset" or (cat == "gpu_memcpy"
                                          and "DtoD" in e["name"])):
            continue                # host rows and host<->device copies
        args = e.get("args", {})
        line = f"stream {args['stream']}" if "stream" in args \
            else f"tid {e.get('tid')}"
        out.append((e["name"], line, float(e["ts"]), float(e["dur"])))
    if not kernels:
        raise RuntimeError(
            f"{path}: a CUDA capture with no kernel rows (the profiler saw "
            "no device activity); its CPU rows are not counted instead")
    return out


def device_op_table(logdir, top=None, sorted_by="total"):
    """Per-op DEVICE-TIME table of the captures under `logdir` (ref
    platform/device_tracer.cc, which correlates CUPTI device spans per
    op): every counted row aggregated by name, calls / total / avg /
    max / min (microseconds). Returns (table_string, rows)."""
    agg: dict[str, list[float]] = {}
    for path in _capture_paths(logdir):
        for name, _line, _ts, dur in _device_rows(path):
            agg.setdefault(name, []).append(dur)
    rows = [{"name": n, "calls": len(d), "total": sum(d),
             "avg": sum(d) / len(d), "max": max(d), "min": min(d)}
            for n, d in agg.items()]
    key = {"total": "total", "calls": "calls", "avg": "avg",
           "max": "max", "min": "min"}.get(sorted_by, "total")
    rows.sort(key=lambda r: r[key], reverse=True)
    if top:
        rows = rows[:top]
    lines = [f"{'Device op':<52}{'Calls':>8}{'Total(us)':>14}"
             f"{'Avg(us)':>12}{'Max(us)':>12}"]
    lines.append("-" * len(lines[0]))
    for r in rows:
        lines.append(
            f"{r['name'][:51]:<52}{r['calls']:>8}{r['total']:>14.1f}"
            f"{r['avg']:>12.1f}{r['max']:>12.1f}")
    return "\n".join(lines), rows


def device_op_events(logdir):
    """Per-event DEVICE intervals of the captures under `logdir`: a flat
    list of ``{name, line, start_us, dur_us}`` rows on the capture's
    clock (`line` is the CUDA stream, or the thread of a CPU capture).
    Where `device_op_table` aggregates totals per name, this keeps every
    occurrence so the overlap report can intersect collective intervals
    with the concurrently-resident compute intervals."""
    return [{"name": name, "line": line, "start_us": ts, "dur_us": dur}
            for path in _capture_paths(logdir)
            for name, line, ts, dur in _device_rows(path)]
