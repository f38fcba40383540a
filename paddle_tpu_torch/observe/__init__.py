"""paddle_tpu_torch.observe — unified runtime telemetry (counterpart of
paddle_tpu.observe).

Four coupled pieces, one import:

* `timeline` / `phase(name)` — nested step-phase spans with bounded
  aggregates, plus `attribute(logdir)` device-time bucketing
  (matmul/attention/collective/elementwise/other) of a `profiler`
  capture.
* `retrace` — global compile-event registry (a compile is the first
  call of a step at a new shape / dtype signature); `no_retrace()`
  raises on any unexpected one, `suppress()` mutes deliberate ones.
* `flight` / `flight_guard()` — always-on bounded black box of recent
  step records, dumped to JSON on crash/preemption/SIGTERM/rollback.
* `snapshot()` / `dump()` / `prometheus_text()` — one export across
  monitor counters, serving metrics, phase aggregates, and goodput.
"""

from .timeline import (  # noqa: F401
    BUCKETS, StepTimeline, attribute, attribute_rows, classify_kernel,
    classify_op, overlap_report, overlap_stats, phase, timeline)
from .retrace import (  # noqa: F401
    RetraceError, annotate, compile_events, no_retrace, record_compile,
    signature_of, suppress)
from . import retrace  # noqa: F401
from .recorder import (FlightRecorder, configure, flight,  # noqa: F401
                       flight_guard, install_signal_handler)
from . import recorder  # noqa: F401
from .export import dump, goodput, prometheus_text, snapshot  # noqa: F401

__all__ = [
    "BUCKETS", "StepTimeline", "attribute", "attribute_rows",
    "classify_kernel", "classify_op",
    "overlap_report", "overlap_stats", "phase", "timeline",
    "RetraceError", "annotate", "compile_events", "no_retrace",
    "record_compile", "signature_of", "suppress", "retrace",
    "FlightRecorder", "configure", "flight", "flight_guard",
    "install_signal_handler", "recorder",
    "dump", "goodput", "prometheus_text", "snapshot",
]


def reset():
    """Reset every observe registry (tests)."""
    timeline.reset()
    retrace.reset()
    flight.reset()
