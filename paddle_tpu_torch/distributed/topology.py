"""The 4-D process topology (counterpart of
paddle_tpu/distributed/topology.py).

`CommunicateTopology` is the reference's named grid of ranks, in its
order (data, pipe, sharding, model; ``topology.py:122-126``).
`HybridCommunicateGroup` gives each rank its coordinates and one
process group per axis: every rank builds every axis's groups, axis by
axis in that order, so no ``new_group`` waits on a rank that builds
another. Where the world holds more ranks than the grid, the ranks
beyond it form further grids of the same shape, each with its own
groups (the reference leaves extra devices out of its mesh).

`get_mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` over the
same groups with the reference's dimension names ("dp", "pp",
"sharding", "mp"; an axis of degree 1 has no group and is left out, a
grid of one rank is the dimension "world"). It names groups only: no
DTensor runs on it, since the hand-written kernels are launched through
ctypes where DTensor's dispatch would not see them.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

from .collective import new_group
from .parallel import device as _env_device
from .parallel import get_rank, get_world_size

__all__ = ["ParallelMode", "CommunicateTopology", "HybridCommunicateGroup",
           "set_hybrid_communicate_group", "get_hybrid_communicate_group",
           "DP_AXIS", "PP_AXIS", "SHARDING_AXIS", "MP_AXIS", "SEP_AXIS"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


# the reference's mesh axis names
DP_AXIS = "dp"
SHARDING_AXIS = "sharding"
PP_AXIS = "pp"
MP_AXIS = "mp"
SEP_AXIS = "sep"


class CommunicateTopology:
    """A named hypercube of ranks with per-axis comm lists."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(
            *(range(d) for d in self._dims)))
        self._world_size = math.prod(self._dims)
        self._rank2coord = dict(zip(range(self._world_size),
                                    self.coordinate))
        self._coord2rank = {c: r for r, c in self._rank2coord.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in self._rank2coord.items() if c[axis] == index]

    def get_comm_list(self, axis_name):
        """All rank lists that form comm groups along `axis_name`."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        comm_list = []
        for other_coord in itertools.product(*(range(d)
                                               for d in other_dims)):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(other_coord)
                coord.insert(axis, i)
                ranks.append(self._coord2rank[tuple(coord)])
            comm_list.append(ranks)
        return comm_list


_AXES = (("data", DP_AXIS), ("pipe", PP_AXIS), ("sharding", SHARDING_AXIS),
         ("model", MP_AXIS))


class HybridCommunicateGroup:
    """The dp x pp x sharding x mp grid over the world's ranks: this
    rank's coordinates and its `collective.Group` along each axis."""

    def __init__(self, topology=None, dp_degree=1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, order=None):
        if topology is not None:
            self._topo = topology
            dp_degree = topology.get_dim("data")
            pp_degree = topology.get_dim("pipe")
            sharding_degree = topology.get_dim("sharding")
            mp_degree = topology.get_dim("model")
        else:
            self._topo = CommunicateTopology(
                ("data", "pipe", "sharding", "model"),
                (dp_degree, pp_degree, sharding_degree, mp_degree))
        self._dp_degree = dp_degree
        self._mp_degree = mp_degree
        self._pp_degree = pp_degree
        self._sharding_degree = sharding_degree

        total = dp_degree * mp_degree * pp_degree * sharding_degree
        world = get_world_size()
        if world % total:
            raise ValueError(
                f"hybrid degrees product {total} does not divide the world "
                f"size {world}")
        self._total = total
        self.global_rank = get_rank()
        # the grid this rank belongs to (more than one when the world is
        # a multiple of the product) starts at global rank `_offset`
        self._offset = (self.global_rank // total) * total
        coord = self._topo.get_coord(self.global_rank % total)
        self._dp_rank, self._pp_rank, self._sharding_rank, \
            self._mp_rank = coord

        groups = {}
        for topo_name, axis in _AXES:
            for base in range(0, world, total):
                for ranks in self._topo.get_comm_list(topo_name):
                    ranks = [base + r for r in ranks]
                    g = new_group(ranks, axis_name=axis)
                    if self.global_rank in ranks:
                        groups[axis] = g
        self._dp_group = groups[DP_AXIS]
        self._pp_group = groups[PP_AXIS]
        self._sharding_group = groups[SHARDING_AXIS]
        self._mp_group = groups[MP_AXIS]
        self._mesh = None

    # -- mesh ----------------------------------------------------------------
    def get_mesh(self):
        """A ``DeviceMesh`` of this rank's grid over the axis groups
        (the dims of "dp", "pp", "sharding", "mp" of degree > 1); groups
        only, no DTensor. Needs an open process group."""
        if self._mesh is None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "get_mesh needs a process group: call "
                    "init_parallel_env (or fleet.init) in a world of "
                    "more than one rank, or give it an init_method")
            from torch.distributed.device_mesh import DeviceMesh

            dev = _env_device()
            dev_type = dev.type if dev is not None else "cpu"
            ranks = torch.arange(self._offset, self._offset + self._total)
            shape = (self._dp_degree, self._pp_degree,
                     self._sharding_degree, self._mp_degree)
            names = (DP_AXIS, PP_AXIS, SHARDING_AXIS, MP_AXIS)
            world = dist.group.WORLD
            pgs = [g.pg if g.pg is not None else world
                   for g in (self._dp_group, self._pp_group,
                             self._sharding_group, self._mp_group)]
            if self._total == 1:
                self._mesh = DeviceMesh.from_group(
                    world, dev_type, mesh=ranks, mesh_dim_names=("world",))
            else:
                keep = [i for i, n in enumerate(shape) if n > 1]
                self._mesh = DeviceMesh.from_group(
                    [pgs[i] for i in keep], dev_type,
                    mesh=ranks.reshape([shape[i] for i in keep]),
                    mesh_dim_names=tuple(names[i] for i in keep))
        return self._mesh

    # -- parallel mode -------------------------------------------------------
    def _check_vpp(self):
        return False

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline parallel
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    def get_check_parallel_group(self, *a, **k):
        return self._dp_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The global rank of pipeline stage `stage_id` at this rank's
        other coordinates."""
        return self._offset + self._topo.get_rank(
            data=self._dp_rank, pipe=stage_id,
            sharding=self._sharding_rank, model=self._mp_rank)

    def rank_coord(self, rank):
        """``(dp, pp, sharding, mp)`` of the global `rank`."""
        return self._topo.get_coord(rank % self._total)


_hcg = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group():
    return _hcg
