from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import Fleet  # noqa: F401
