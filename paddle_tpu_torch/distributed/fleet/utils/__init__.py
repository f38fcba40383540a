"""Fleet utilities ported so far: activation recomputation."""

from .recompute import RecomputeSequential, recompute  # noqa: F401
