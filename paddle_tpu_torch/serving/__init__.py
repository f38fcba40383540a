"""Continuous-batching GPT serving (single engine)."""

from .engine import SlotEngine  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .paging import (  # noqa: F401
    NULL_BLOCK, BlockAllocator, PoolExhausted, PrefixCache, positions_to_rows,
)
from .queueing import (  # noqa: F401
    AdmissionQueue, CapacityExhaustedError, DeadlineExceededError,
    QueueFullError, Request, RequestCancelled, ServerClosedError,
    ServingError,
)
from .server import Server  # noqa: F401
