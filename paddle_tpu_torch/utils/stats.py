"""Shared order-statistics helpers: linear-interpolation percentiles
(numpy's 'linear' method) for the serving latency series."""

from __future__ import annotations

__all__ = ["percentile"]


def _interp(data, p):
    """`data` already sorted ascending, non-empty; p in [0, 100]."""
    rank = (len(data) - 1) * (p / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(data) - 1)
    return data[lo] + (data[hi] - data[lo]) * (rank - lo)


def percentile(samples, p):
    """Linear-interpolation percentile over an unsorted sequence."""
    if not 0 <= p <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    data = sorted(samples)
    if not data:
        raise ValueError("no samples")
    return _interp(data, p)

