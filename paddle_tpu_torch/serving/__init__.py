"""Serving on one card: the continuous-batching GPT engine (speculative
decoding, batched LoRA banks, the SSD KV spill tier, KV migration), the
dynamic batcher, the resilient replica fleet (`ReplicaSet` / `Router`:
failover replay, retries, hedging, breakers, brownout, elastic
membership, prefix affinity, disaggregated prefill/decode), the
`Autoscaler`, weight rollout (`WeightRegistry` / `RolloutController`),
tenancy (`TenantDirectory` / `TenantFairQueue` / `ArtifactCatalog` /
`AdapterRollout`), the open-loop workload simulator and the
`Server` / `http_front` shell.

Waiting in this port: mesh-sharded serving (`ShardingPlan` and the
rest of serving/sharding.py), the Prometheus exposition
(`Server.metrics_prometheus`), `Server.from_predictor` and
``http_front(ranker=)``.
"""

from .autoscale import Autoscaler, SLOWindow  # noqa: F401
from .batcher import (  # noqa: F401
    DynamicBatcher, bucket_for, bucket_ladder, pad_batch,
)
from .engine import SlotEngine, speculative_accept  # noqa: F401
from .fleet import (  # noqa: F401
    CircuitBreaker, Replica, ReplicaSet, Router, retriable,
)
from .kvstore import (  # noqa: F401
    KVSpillStore, SpillFencedError, open_spill_store, reset_spill_stores,
)
from .metrics import ServingMetrics, percentile  # noqa: F401
from .migrate import (  # noqa: F401
    KVMailbox, PeerGoneError, migrate_prefix, payload_bytes,
)
from .paging import (  # noqa: F401
    NULL_BLOCK, BlockAllocator, PoolExhausted, PrefixCache, positions_to_rows,
)
from .queueing import (  # noqa: F401
    AdmissionQueue, BrownoutShedError, CapacityExhaustedError,
    DeadlineExceededError, QueueFullError, ReplicaDiedError, Request,
    RequestCancelled, RetriesExhaustedError, ServerClosedError,
    ServingError, TenantBudgetError, TenantFairQueue, VersionRetiredError,
)
from .rollout import (  # noqa: F401
    RolloutController, RolloutError, RolloutGateError, WeightRegistry,
    WeightVersion, golden_digests,
)
from .server import Server, http_front  # noqa: F401
from .tenancy import (  # noqa: F401
    DEFAULT_TENANT, AdapterRollout, Artifact, ArtifactCatalog,
    TenantDirectory, TenantSpec,
)
from .workload import Arrival, Scenario, replay  # noqa: F401

__all__ = [
    "AdapterRollout", "AdmissionQueue", "Arrival", "Artifact",
    "ArtifactCatalog", "Autoscaler", "BlockAllocator",
    "BrownoutShedError", "CapacityExhaustedError", "CircuitBreaker",
    "DEFAULT_TENANT", "DeadlineExceededError", "DynamicBatcher",
    "KVMailbox", "KVSpillStore", "NULL_BLOCK", "PeerGoneError",
    "PoolExhausted", "PrefixCache", "QueueFullError", "Replica",
    "ReplicaDiedError", "ReplicaSet", "Request", "RequestCancelled",
    "RetriesExhaustedError", "RolloutController", "RolloutError",
    "RolloutGateError", "Router", "SLOWindow", "Scenario", "Server",
    "ServerClosedError", "ServingError", "ServingMetrics", "SlotEngine",
    "SpillFencedError", "TenantBudgetError", "TenantDirectory",
    "TenantFairQueue", "TenantSpec", "VersionRetiredError",
    "WeightRegistry", "WeightVersion",
    "bucket_for", "bucket_ladder", "golden_digests", "http_front",
    "migrate_prefix", "open_spill_store", "pad_batch", "payload_bytes",
    "percentile", "positions_to_rows", "replay", "reset_spill_stores",
    "retriable", "speculative_accept",
]
