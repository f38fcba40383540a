"""Meta-optimizers (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers): `HybridParallelOptimizer`,
which `fleet.distributed_optimizer` returns. DGC, LocalSGD and
`DygraphShardingOptimizer` wait in ROADMAP queue A item 4 (ZeRO runs in
the engines)."""

from .dygraph_optimizer import HybridParallelOptimizer  # noqa: F401
