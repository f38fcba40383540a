"""Distributed training on ``torch.distributed`` (counterpart of
paddle_tpu/distributed): one process per rank, NCCL on cards, gloo on
the CPU. `parallel` (the environment, `init_parallel_env`),
`collective` (the collectives over process groups), `topology` (the
hybrid dp x pp x sharding x mp grid), `fleet` (the facade, the Megatron
TP layers, the uniform pipeline, `utils.recompute`), `sharding` (the
gradient synchronisation and ZeRO of the engines), `hybrid`
(`HybridParallelEngine`, `make_gpt_hybrid_engine`), and the
single-process half of `checkpoint` and `preempt`."""

from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    barrier, broadcast, get_group, new_group, recv, reduce, reduce_scatter,
    scatter, send, split, wait,
)
from .parallel import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode,
)
from . import fleet  # noqa: F401
