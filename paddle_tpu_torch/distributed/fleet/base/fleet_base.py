"""The fleet facade (counterpart of
paddle_tpu/distributed/fleet/base/fleet_base.py).

`Fleet.init` opens the process group (`init_parallel_env`) and builds
the `HybridCommunicateGroup` from ``strategy.hybrid_configs`` (a
``dp_degree`` of -1 takes what the world leaves); `distributed_model`
wraps by parallel mode (a `PipelineLayer` in a `PipelineParallel`) and
`distributed_optimizer` returns a `HybridParallelOptimizer`. The parameter-server mode
(``distributed/ps``) is not ported: a `PSRoleMaker` raises.
"""

from __future__ import annotations

from ...collective import _reset_default_group
from ...parallel import (
    ParallelEnv, get_rank, get_world_size, init_parallel_env,
)
from ...topology import (
    HybridCommunicateGroup, ParallelMode, set_hybrid_communicate_group,
)
from .distributed_strategy import DistributedStrategy

__all__ = ["Fleet"]


class _RoleMaker:
    def __init__(self, is_collective=True):
        self._is_collective = is_collective

    def _is_non_distributed(self):
        return get_world_size() <= 1


class Fleet:
    def __init__(self):
        self._role_maker = None
        self._hcg = None
        self._user_defined_strategy = None
        self._is_initialized = False

    # -- init ----------------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None,
             backend=None, device=None, init_method=None):
        """Open the world (`init_parallel_env` with `backend`, `device`
        and `init_method`) and build the hybrid group of
        ``strategy.hybrid_configs``."""
        if role_maker is not None and not isinstance(role_maker,
                                                     _RoleMaker):
            raise NotImplementedError(
                "fleet.init with a parameter-server role maker: "
                "distributed/ps is not ported (ROADMAP queue A item 5)")
        if strategy is None:
            strategy = DistributedStrategy()
        self._user_defined_strategy = strategy
        self._role_maker = role_maker or _RoleMaker(is_collective)
        init_parallel_env(backend=backend, device=device,
                          init_method=init_method)
        _reset_default_group()

        hc = strategy.hybrid_configs
        world = get_world_size()
        mp = max(int(hc.get("mp_degree", 1)), 1)
        pp = max(int(hc.get("pp_degree", 1)), 1)
        sh = max(int(hc.get("sharding_degree", 1)), 1)
        dp = int(hc.get("dp_degree", -1))
        if dp <= 0:
            dp = max(world // (mp * pp * sh), 1)
        if int(hc.get("sep_degree", 1)) > 1:
            raise NotImplementedError(
                "sep_degree > 1 (context parallelism, context_parallel.py) "
                "waits in ROADMAP queue A item 4")
        self._hcg = HybridCommunicateGroup(
            dp_degree=dp, mp_degree=mp, pp_degree=pp, sharding_degree=sh)
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    # -- info ----------------------------------------------------------------
    def get_hybrid_communicate_group(self):
        return self._hcg

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_first_worker(self):
        return get_rank() == 0

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from ...collective import barrier

        barrier()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def hcg(self):
        return self._hcg

    # -- model / optimizer wrapping -----------------------------------------
    def distributed_model(self, model):
        """`PipelineParallel` of a `PipelineLayer` in pipeline mode;
        `DataParallel` in data-parallel mode with dp > 1; the model
        itself otherwise (its TP layers read the hybrid group when they
        are built; the engines drive pipeline and ZeRO)."""
        from ....dataparallel import DataParallel
        from ..meta_parallel.pipeline_parallel import PipelineParallel
        from ..meta_parallel.pp_layers import PipelineLayer

        if self._hcg is None:
            self.init()
        mode = self._hcg.get_parallel_mode()
        if mode == ParallelMode.PIPELINE_PARALLEL and \
                isinstance(model, PipelineLayer):
            return PipelineParallel(model, self._hcg,
                                    self._user_defined_strategy)
        if mode == ParallelMode.DATA_PARALLEL and \
                self._hcg.get_data_parallel_world_size() > 1:
            return DataParallel(model,
                                group=self._hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from ..meta_optimizers.dygraph_optimizer import \
            HybridParallelOptimizer

        if strategy is not None:
            self._user_defined_strategy = strategy
        return HybridParallelOptimizer(
            optimizer, self._hcg, self._user_defined_strategy)

    def distributed_scaler(self, scaler):
        return scaler

    def minimize(self, optimizer, loss, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        optimizer.step()
        return None, []
