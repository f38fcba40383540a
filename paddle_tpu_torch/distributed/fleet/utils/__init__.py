"""Fleet utilities ported so far: activation recomputation."""

from .recompute import (  # noqa: F401
    RecomputeSequential, recompute, remat_wrapper,
)
