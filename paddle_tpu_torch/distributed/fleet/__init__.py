"""Fleet (counterpart of paddle_tpu/distributed/fleet): the facade over
a singleton `Fleet`, the meta-parallel layers and engines, and
`utils.recompute`. The parameter-server surface and ``fleet.metrics``
are not ported (ROADMAP queue A items 4-5)."""

from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.fleet_base import Fleet
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401
from .utils.recompute import recompute  # noqa: F401

fleet = Fleet()

init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
distributed_scaler = fleet.distributed_scaler
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
worker_endpoints = fleet.worker_endpoints
barrier_worker = fleet.barrier_worker
minimize = fleet.minimize
