"""Single-card serving: the continuous-batching GPT engine (speculative
decoding, batched LoRA banks, the SSD KV spill tier, KV migration) and
the dynamic batcher."""

from .batcher import (  # noqa: F401
    DynamicBatcher, bucket_for, bucket_ladder, pad_batch,
)
from .engine import SlotEngine, speculative_accept  # noqa: F401
from .kvstore import (  # noqa: F401
    KVSpillStore, SpillFencedError, open_spill_store, reset_spill_stores,
)
from .metrics import ServingMetrics  # noqa: F401
from .migrate import (  # noqa: F401
    KVMailbox, PeerGoneError, migrate_prefix, payload_bytes,
)
from .paging import (  # noqa: F401
    NULL_BLOCK, BlockAllocator, PoolExhausted, PrefixCache, positions_to_rows,
)
from .queueing import (  # noqa: F401
    AdmissionQueue, CapacityExhaustedError, DeadlineExceededError,
    QueueFullError, Request, RequestCancelled, ServerClosedError,
    ServingError,
)
from .server import Server  # noqa: F401
