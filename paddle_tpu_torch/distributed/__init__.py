"""Distributed training on ``torch.distributed`` (counterpart of
paddle_tpu/distributed): one process per rank, NCCL on cards, gloo on
the CPU. `parallel` (the environment, `init_parallel_env`),
`collective` (the collectives over process groups), `topology` (the
hybrid dp x pp x sharding x mp grid), `fleet` (the facade, the Megatron
TP layers, the uniform pipeline, `utils.recompute`), `sharding` (the
gradient synchronisation and ZeRO of the engines), `hybrid`
(`HybridParallelEngine`, `make_gpt_hybrid_engine`), `checkpoint`
(single-process, meshed, hybrid and gang-committed), `preempt`, and
resilience across ranks: `gang` (deadlines on the collectives, typed
peer errors, `GangWorker`, `GangSupervisor`), `elastic` (the heartbeat
registry) and `launch` (``python -m paddle_tpu_torch.distributed.launch``,
imported on first use so that ``-m`` runs it fresh)."""

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
from . import checkpoint  # noqa: F401
from . import elastic  # noqa: F401
from . import gang  # noqa: F401
from . import preempt  # noqa: F401


def __getattr__(name):
    if name == "launch":
        import importlib

        return importlib.import_module(".launch", __name__)
    raise AttributeError(name)


def spawn(func, args=(), nprocs=-1, **kwargs):
    """ref: distributed/spawn.py, with the reference's contract: for
    nprocs <= 1 a direct call in this process; several processes on one
    host go through the launcher."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return
    raise NotImplementedError(
        "multi-process spawn is not the execution model; start the ranks "
        "with python -m paddle_tpu_torch.distributed.launch "
        "--nproc_per_node N script.py")
