"""Runtime telemetry (counterpart of paddle_tpu.observe): so far only
the flight recorder, an always-on bounded black box of recent step
records and notes, dumped to JSON on crash, preemption, SIGTERM and
anomaly rollback. The reference's ``timeline`` / ``phase`` spans,
``retrace`` and ``export`` are not ported yet."""

from .recorder import (FlightRecorder, configure, flight,  # noqa: F401
                       flight_guard, install_signal_handler)
from . import recorder  # noqa: F401

__all__ = ["FlightRecorder", "configure", "flight", "flight_guard",
           "install_signal_handler", "recorder"]
