"""Step timeline: bounded per-phase aggregates + device-time attribution
(counterpart of paddle_tpu/observe/timeline.py).

The runtime's engines wrap each stage of a step in a named phase::

    host-prep            batch normalization, fault points, host->device
                         copies of the batch, the learning rate
    compile              a step call at a new (shape, dtype) signature
    device-step          the step's launches (training + decode)
    anomaly-readback     the guard's host sync at step boundaries
    sample               serving host-side token sampling
    draft                speculative decoding's draft micro-steps
    checkpoint-snapshot  device->host state copy on the step thread
    checkpoint-write     synchronous checkpoint serialization + commit
    checkpoint-write-async  the same, on the background writer thread
    checkpoint-restore   checkpoint load/verify

A phase measures host wall time: the card runs behind the host, and no
phase synchronises with it (that would change the step's pipelining).
Each `phase(...)` context both emits a `profiler.RecordEvent` span (so
phases land in the host chrome trace and, while a torch profiler runs,
in its trace) and folds the duration into an O(1) per-phase aggregate
here — the aggregate is what `goodput()` and the Prometheus export
read, so the timeline stays bounded no matter how long the run is.

`attribute(logdir)` classifies the device time of a `profiler` capture
into matmul / attention / collective / elementwise / other buckets —
`Engine.attribute_step()` is the one-call front for it. Kernel rows
(demangled CUDA names such as ``void at::native::reduce_kernel<...>(...)``
and a CPU capture's ``aten::`` ops) are cut to their base name and
looked up in the port's table of kernels first (`_KERNELS`: every
hand-written kernel of ``csrc/`` under its kernel id, and torch's CPU
matmul ops; then `_LIBRARY`: the torch, cuBLAS, cuDNN and NCCL kernel
families the port's paths launch); only then do the reference's regexes
apply. Other names go through the reference's rules unchanged.
`classify_kernel` also returns the kernel id or family that decided, the
drill-down under each bucket.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time

__all__ = ["StepTimeline", "timeline", "phase", "BUCKETS", "classify_op",
           "classify_kernel", "attribute", "attribute_rows",
           "overlap_stats", "overlap_report"]


class StepTimeline:
    """Thread-safe phase aggregator: name -> calls/total/max seconds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._agg: dict = {}  # name -> [calls, total_s, max_s]

    @contextlib.contextmanager
    def phase(self, name, cat="phase"):
        from .. import profiler

        t0 = time.perf_counter()
        try:
            with profiler.RecordEvent(f"step.{name}", cat=cat):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                c = self._agg.setdefault(name, [0, 0.0, 0.0])
                c[0] += 1
                c[1] += dt
                c[2] = max(c[2], dt)

    def add(self, name, seconds):
        """Fold an externally-timed duration into a phase aggregate."""
        with self._lock:
            c = self._agg.setdefault(name, [0, 0.0, 0.0])
            c[0] += 1
            c[1] += seconds
            c[2] = max(c[2], seconds)

    def aggregates(self):
        with self._lock:
            return {
                name: {"calls": c[0], "total_s": c[1],
                       "avg_s": c[1] / c[0] if c[0] else 0.0,
                       "max_s": c[2]}
                for name, c in self._agg.items()
            }

    def total(self, name):
        with self._lock:
            c = self._agg.get(name)
            return c[1] if c else 0.0

    def reset(self):
        with self._lock:
            self._agg.clear()


#: process-global timeline every engine reports into
timeline = StepTimeline()
phase = timeline.phase


# ---------------------------------------------------------------------------
# device-time attribution
# ---------------------------------------------------------------------------

BUCKETS = ("matmul", "attention", "collective", "elementwise", "other")

#: the port's kernels by base name -> (bucket, kernel): every
#: hand-written kernel of csrc/ under its kernel id, torch's CPU matmul
#: ops (the rows of a device="cpu" capture) and its permute view (not a
#: collective permute)
_KERNELS = {
    # B1-B3, flash attention (csrc/flash_attn.cu): the bf16 tensor-core
    # and the f32 passes, and the dropout mask's checking kernel
    **dict.fromkeys(("fwd_kernel_mma", "fwd_kernel"), ("attention", "B1")),
    **dict.fromkeys(("dq_kernel_mma", "dq_kernel"), ("attention", "B2")),
    **dict.fromkeys(("dkv_kernel_mma", "dkv_kernel"), ("attention", "B3")),
    "keep_mask_kernel": ("attention", "B1-B3"),
    # B4-B6, the LM head's products with the lse epilogue
    # (csrc/fused_loss.cu): B5 and B6 share one kernel
    "lse_kernel": ("matmul", "B4"),
    **dict.fromkeys(("wg_kernel", "tc_kernel"), ("matmul", "B5-B6")),
    "f32_kernel": ("matmul", "B4-B6"),
    # B7 / B8, the serving head's table streams (csrc/quant_ops.cu,
    # csrc/lowp.cu); B9's GEMM and its quantise passes (csrc/lowp.cu);
    # B10, the fused conv (csrc/fused_conv.cu)
    "dq_stream": ("matmul", "B7"),
    "w8a8_stream": ("matmul", "B8"),
    "qmm_wg": ("matmul", "B9"),
    **dict.fromkeys(("quant_rows", "quant_cols"), ("elementwise", "B9")),
    **dict.fromkeys(("wg_conv", "f32_conv"), ("matmul", "B10")),
    **dict.fromkeys(("mm", "addmm", "bmm", "baddbmm", "linear", "matmul",
                     "mv", "addmv", "einsum", "conv2d", "convolution",
                     "_convolution"), ("matmul", "torch matmul")),
    "permute": ("elementwise", "torch view"),
}

#: library kernel families, (bucket, family, fragments of the qualified
#: name: no template arguments, no parameters); the first match wins
_LIBRARY = (
    ("collective", "NCCL", ("nccl",)),
    # cuDNN's layout transforms, then its conv kernels (weight / data
    # gradients, implicit GEMMs, Winograd, its CUTLASS kernels), then
    # cuBLAS (Hopper's nvjet GEMMs, xmma, split-K reductions) and CUTLASS
    ("elementwise", "cuDNN layout", ("nchwToNhwc", "nhwcToNchw")),
    ("matmul", "cuDNN conv", ("wgrad", "dgrad", "implicit", "winograd",
                              "cudnn")),
    ("matmul", "cuBLAS GEMM", ("nvjet", "xmma", "gemm", "Gemm", "gemv",
                               "cutlass", "splitKreduce")),
    # torch's reduction and elementwise templates (its RNG's too), its
    # index / scatter / gather kernels, device-to-device copies and
    # memsets
    ("elementwise", "torch reduction", ("reduce_kernel",)),
    ("elementwise", "torch elementwise", ("elementwise",)),
    ("elementwise", "torch index / scatter / gather",
     ("index", "Index", "scatter", "gather")),
    ("elementwise", "device copy / memset", ("Memcpy DtoD", "Memset")),
)

# runtime-framework events on the xplane are bookkeeping, not ops —
# e.g. "TfrtCpuExecutable::Execute", "PjitFunction(f)", threadpool
# listeners, and our own "step.*" trace annotations
_FRAMEWORK_RE = re.compile(
    r"::|\(|^(ParseArguments|Thread|Thunk|Stream|Xla|TSL|jit_|Infeed|"
    r"Outfeed|program|shard_args|DevicePut|device_put|BufferFrom|"
    r"TransferTo|CopyTo|H2D|D2H|step\.|serving\.|checkpoint\.|train\.)")

# HLO control-flow wrappers: a `call.3` / `while.2` row's duration
# encloses its children, which appear as their own rows — counting the
# wrapper double-counts the body (seen with the remat'd block scan)
_WRAPPER_RE = re.compile(r"^(call|while|conditional)(\.\d+)?$")

# ordered: the first matching bucket wins (softmax -> attention even
# though a fused name may also contain "multiply"; "convert" must not
# hit the matmul "conv" pattern). Collective names are separator-
# tolerant: fusion rows spell them with underscores (`all_gather_fusion`
# vs the plain op's `all-gather.3`); NCCL's kernels by their prefix,
# cuBLAS's Hopper GEMMs (nvjet) with the matmuls
_BUCKET_RES = (
    ("collective", re.compile(
        r"all[-_]reduce|all[-_]gather|all[-_]to[-_]all|"
        r"reduce[-_]scatter|collective|permute|psum|send|recv|nccl")),
    ("attention", re.compile(r"attention|flash|mha|softmax")),
    ("matmul", re.compile(r"dot|conv(?!ert)|gemm|einsum|matmul|nvjet")),
    ("elementwise", re.compile(
        r"add|sub(?!scribe)|mul|div|max|min|exp|log|tanh|relu|sqrt|"
        r"select|compare|broadcast|reduce|convert|fusion|transpose|"
        r"copy|concat|slice|pad|iota|rng|scatter|gather|clamp|power|"
        r"neg|sign|floor|erf|bitcast|reshape|update|tuple|constant")),
)


_LIBRARY_PLAIN_RE = re.compile(r"^(nvjet|sm\d+_xmma|cutlass)")


def _is_kernel_row(name):
    """A CUDA kernel (demangled, plain-named as cuBLAS's and cuDNN's
    are, or left mangled by the profiler), a CUDA copy / memset row or
    a torch op, as opposed to an XLA-style op name."""
    return name.startswith(("void ", "aten::", "Memcpy ", "Memset ", "_Z")) \
        or "<" in name or "(anonymous namespace)" in name \
        or _LIBRARY_PLAIN_RE.match(name) is not None


def _qualified_name(name):
    """`name` without ``void``, anonymous namespaces, template arguments
    and the parameter list (namespaces kept)."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip()


def classify_kernel(name):
    """(bucket, kernel) of one device-op name: `kernel` is the port's
    kernel id (``"B1"``...) or library family that decided the bucket,
    None where the reference's regexes did; (None, None) for
    runtime-framework rows."""
    if name.startswith("$"):
        return None, None
    if _is_kernel_row(name):
        qual = _qualified_name(name)
        base = qual.rsplit("::", 1)[-1]
        if base in _KERNELS:
            return _KERNELS[base]
        for bucket, family, frags in _LIBRARY:
            if any(f in qual for f in frags):
                return bucket, family
        low = base.lower()
    else:
        if _FRAMEWORK_RE.search(name):
            return None, None
        low = name.lower()
        if _WRAPPER_RE.match(low):
            return None, None
    for bucket, rx in _BUCKET_RES:
        if rx.search(low):
            return bucket, None
    return "other", None


def classify_op(name):
    """Bucket one device-op name, or None for runtime-framework rows."""
    return classify_kernel(name)[0]


def attribute_rows(rows, top=10):
    """Classify `profiler.device_op_table` rows into the buckets.

    Framework rows (executor/jit shells that enclose the real ops) are
    dropped so bucket totals do not double-count; the report carries
    the top per-op rows for drill-down."""
    buckets = {b: 0.0 for b in BUCKETS}
    ops = []
    for r in rows:
        b = classify_op(r["name"])
        if b is None:
            continue
        buckets[b] += r["total"]
        ops.append({**r, "bucket": b})
    ops.sort(key=lambda r: r["total"], reverse=True)
    total = sum(buckets.values())
    return {
        "buckets": buckets,
        "fractions": {b: (v / total if total else 0.0)
                      for b, v in buckets.items()},
        "total_us": total,
        "top_ops": ops[:top],
    }


def attribute(logdir, top=10):
    """Parse the captures under `logdir` and bucket device time."""
    from .. import profiler

    _, rows = profiler.device_op_table(logdir)
    return attribute_rows(rows, top=top)


def _merge_intervals(ivs):
    """Union of (start, end) intervals, sorted and coalesced."""
    merged = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _covered(iv, merged):
    """Length of interval `iv` covered by the merged union."""
    s, e = iv
    cov = 0.0
    for ms, me in merged:
        if me <= s:
            continue
        if ms >= e:
            break
        cov += min(e, me) - max(s, ms)
    return cov


def overlap_stats(events):
    """Pair collective device time against CONCURRENTLY-RESIDENT compute.

    events: `profiler.device_op_events` rows (per-occurrence intervals
    on the capture's shared clock). Every collective interval is
    intersected with the union of matmul+attention intervals across all
    streams: the covered part is collective time hidden behind compute;
    the rest is exposed — time the interconnect serializes the step.
    `exposed_collective_frac` (exposed collective time over total
    classified device time) is the headline."""
    comp, coll = [], []
    compute_us = collective_us = total_us = 0.0
    for e in events:
        b = classify_op(e["name"])
        if b is None:
            continue
        iv = (e["start_us"], e["start_us"] + e["dur_us"])
        total_us += e["dur_us"]
        if b == "collective":
            coll.append(iv)
            collective_us += e["dur_us"]
        elif b in ("matmul", "attention"):
            comp.append(iv)
            compute_us += e["dur_us"]
    merged = _merge_intervals(comp)
    hidden = sum(_covered(iv, merged) for iv in coll)
    exposed = max(collective_us - hidden, 0.0)
    return {
        "collective_us": collective_us,
        "compute_us": compute_us,
        "hidden_collective_us": hidden,
        "exposed_collective_us": exposed,
        "exposed_collective_frac": (exposed / total_us
                                    if total_us else 0.0),
        "collective_share": (collective_us / total_us
                             if total_us else 0.0),
        "total_us": total_us,
    }


def overlap_report(logdir):
    """Parse the captures under `logdir` and report how much collective
    time hides behind concurrently-resident compute (see
    overlap_stats)."""
    from .. import profiler

    return overlap_stats(profiler.device_op_events(logdir))
