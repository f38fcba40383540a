"""The meshed step's rules, shared by the port's two meshed engines
(`engine.Engine(mesh=)` and `hybrid.HybridParallelEngine`): the dp
slice of the global batch, gradient synchronisation, ZeRO and the loss
over the global batch (the reference expresses them as shardings in its
compiled step: ``engine.py:212-267`` and
``distributed/hybrid.py:130-166``).

Each rank takes its dp slice of the global batch (`dp_slice`), holds
its model-parallel shards and runs forward and backward eagerly; then,
in this order (`ZeroSharding.update`):

1. the gradients of parameters replicated over mp whose users see only
   this rank's part of the sequence under sequence parallelism
   (``param.sequence_parallel``) are summed over mp;
2. a pipeline's replicated parameters (the embeddings, the final norm,
   the tied head) are summed over pp, each stage holding the part of the
   gradient its own uses gave;
3. every gradient is averaged over dp;
4. ZeRO, over the ``sharding`` group (whose ranks see the same batch, as
   the reference's ``P("dp")`` batch spec gives them): stage 1 updates
   each rank's slice of a sharded leaf from its slice of the optimizer
   state and all-gathers the parameter; stage 2 first reduce-scatters
   the gradient (averaged: the ranks' gradients agree); stage 3 also
   keeps only the parameter's slice between steps, all-gathering the
   full parameter into the model before the forward
   (`ZeroSharding.gather_params`) and freeing it after the update.

The leaf rule is the reference's ``_opt_leaf_spec``: a leaf is sharded
along the first dimension of its logical shape that model parallelism
does not split, that is larger than 1 and that the degree divides;
scalars replicate; a leaf otherwise replicated with no such dimension
warns once and replicates. ``offload=True`` keeps the optimizer state in
pinned host memory between steps (plain host memory on a CPU run).

The loss a rank computes is its slice's; `global_mean` averages it over
dp. That is the global batch's mean when every slice weighs the same.
A loss weighted by a mask (``sum(loss * m) / sum(m)``) is not: inside
`global_batch`, which the meshed `Engine` opens around its loss,
`batch_weight` gives the criterion the mask sum of the whole global
batch, spread over the dp ranks, so that the dp average of the ranks'
losses (and of their gradients) is the global batch's ratio, as the
reference's single program computes it.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from .collective import all_gather_cat, all_reduce, reduce_scatter_dim

__all__ = ["dp_slice", "global_mean", "global_batch", "batch_weight",
           "zero_dim", "sync_sequence_parallel_grads", "sync_grads",
           "ZeroSharding", "check_waiting_flags"]

# the hybrid groups of the meshed steps whose loss is being computed
_GLOBAL_BATCH = []


def check_waiting_flags():
    """Raise when a flag of a distributed feature that waits is on."""
    from ..framework.flags import flag

    if flag("FLAGS_mp_overlap"):
        raise NotImplementedError(
            "FLAGS_mp_overlap (ops/overlap.py, the ring collective-matmul) "
            "waits in ROADMAP queue A item 4")


def dp_slice(x, hcg):
    """This rank's dp slice of a global batch leaf (a tensor or an
    array): its rows ``[r n, (r + 1) n)`` for dp rank r of dp, n =
    rows / dp."""
    dp = hcg.get_data_parallel_world_size()
    if dp <= 1:
        return x
    n = len(x) // dp
    r = hcg.get_data_parallel_rank()
    return x[r * n:(r + 1) * n]


def global_mean(loss, hcg):
    """A rank's loss averaged over dp (a float32 0-dim tensor, the same
    on every rank): the mean over the global batch."""
    loss = loss.float()
    dp = hcg.get_data_parallel_world_size()
    if dp > 1:
        loss = all_reduce(loss.clone(),
                          group=hcg.get_data_parallel_group()) / dp
    return loss


@contextlib.contextmanager
def global_batch(hcg):
    """While a meshed step computes its loss on this rank's dp slice:
    `batch_weight` answers for the global batch."""
    _GLOBAL_BATCH.append(hcg)
    try:
        yield
    finally:
        _GLOBAL_BATCH.pop()


def batch_weight(w):
    """``(total, parts)`` for a rank's loss weight `w` (a 0-dim tensor,
    e.g. a loss mask's sum): inside `global_batch`, the sum of `w` over
    dp and the dp degree; elsewhere ``(w, 1)``. A loss ``num * parts /
    total`` averaged over the dp ranks is then ``sum(num) / total``."""
    if not _GLOBAL_BATCH:
        return w, 1
    hcg = _GLOBAL_BATCH[-1]
    dp = hcg.get_data_parallel_world_size()
    if dp <= 1:
        return w, 1
    total = all_reduce(w.detach().float().clone(),
                       group=hcg.get_data_parallel_group())
    return total, dp


def zero_dim(shape, split_axis, degree):
    """The dimension a ZeRO leaf of `shape` is sharded along (None:
    replicated). `split_axis` is the dimension model parallelism
    splits (None for a replicated parameter)."""
    if degree <= 1 or len(shape) == 0:
        return None
    for i, n in enumerate(shape):
        if i != split_axis and n > 1 and n % degree == 0:
            return i
    return None


def _all_reduce_coalesced(tensors, group, scale=None):
    """Sum `tensors` over `group` in one collective (in place), then
    multiply by `scale` when given."""
    tensors = [t for t in tensors if t is not None]
    if not tensors or group.pg is None:
        if scale is not None:
            for t in tensors:
                t.mul_(scale)
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def sync_sequence_parallel_grads(grads, params, hcg):
    """Sum over mp, in place, the gradients of the parameters marked
    ``sequence_parallel``."""
    if hcg.get_model_parallel_world_size() <= 1:
        return
    marked = [grads[k] for k, p in params.items()
              if getattr(p, "sequence_parallel", False)]
    _all_reduce_coalesced(marked, hcg.get_model_parallel_group())


@torch.no_grad()
def sync_grads(grads, params, hcg, pipeline_shared=()):
    """Steps 1-3 of the module docstring, in place on the ``{name:
    grad}`` dict; `pipeline_shared` names the parameters to sum over
    pp."""
    sync_sequence_parallel_grads(grads, params, hcg)
    if hcg.get_pipe_parallel_world_size() > 1 and pipeline_shared:
        _all_reduce_coalesced([grads[k] for k in pipeline_shared],
                              hcg.get_pipe_parallel_group())
    dp = hcg.get_data_parallel_world_size()
    if dp > 1:
        _all_reduce_coalesced(list(grads.values()),
                              hcg.get_data_parallel_group(), 1.0 / dp)


def _pin(t):
    """`t` in pinned host memory (plain host memory when no card is
    visible)."""
    t = t.detach().to("cpu")
    return t.pin_memory() if torch.cuda.is_available() else t


class ZeroSharding:
    """The optimizer state of `params` (``{name: Parameter}``), sharded
    over the hybrid group's sharding axis at `stage` (0 replicates
    everything), and the update that goes with it."""

    def __init__(self, params, optimizer, hcg, stage=0, offload=False):
        self.optimizer = optimizer
        self.hcg = hcg
        self.stage = int(stage)
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {stage}")
        self.offload = bool(offload)
        self.group = hcg.get_sharding_parallel_group()
        self.degree = hcg.get_sharding_parallel_world_size() \
            if self.stage else 1
        self.rank = hcg.get_sharding_parallel_rank()
        self.params = dict(params)
        self.dims = {}
        self.warned = set()
        for k, p in self.params.items():
            split = getattr(p, "split_axis", None)
            d = zero_dim(tuple(p.shape), split, self.degree)
            self.dims[k] = d
            if d is None and split is None and p.dim() > 0 and \
                    p.numel() >= self.degree > 1 and k not in self.warned:
                self.warned.add(k)
                warnings.warn(
                    f"ZeRO: state/gradient for '{k}' (shape "
                    f"{tuple(p.shape)}) has no dim divisible by sharding "
                    f"degree {self.degree}; replicating", stacklevel=3)
        # stage 3: the parameters' own slices, the state of truth
        self.shards = {}
        if self.stage >= 3:
            for k, p in self.params.items():
                if self.dims[k] is not None:
                    self.shards[k] = self._slice(k, p.detach()).clone()
        self.states = {k: optimizer._init_state(self._own(k))
                       for k in self.params}
        if self.offload:
            self.states = self._move(self.states, _pin)
        if self.stage >= 3:
            self.release_params()

    # -- slicing -------------------------------------------------------------
    def _slice(self, k, t):
        d = self.dims[k]
        n = t.shape[d] // self.degree
        return t.narrow(d, self.rank * n, n)

    def _own(self, k):
        """This rank's part of parameter `k` (a view of the parameter,
        or its kept slice under stage 3)."""
        if self.dims[k] is None:
            return self.params[k].detach()
        if self.stage >= 3:
            return self.shards[k]
        return self._slice(k, self.params[k].detach())

    # -- stage 3 -------------------------------------------------------------
    @torch.no_grad()
    def gather_params(self):
        """Stage 3: all-gather every sharded parameter into the model (a
        no-op below stage 3, whose parameters rest whole)."""
        for k, shard in self.shards.items():
            self.params[k].data = all_gather_cat(shard, self.dims[k],
                                                 self.group)

    def release_params(self):
        """Stage 3: free the gathered parameters (their slices stay)."""
        for k, shard in self.shards.items():
            p = self.params[k]
            p.data = torch.empty(0, dtype=shard.dtype, device=shard.device)

    # -- the update ----------------------------------------------------------
    def update(self, grads, lr, metas, pipeline_shared=()):
        """The meshed step's tail on a ``{name: grad}`` dict of every
        parameter: `sync_grads`, then the (ZeRO) update."""
        sync_grads(grads, self.params, self.hcg, pipeline_shared)
        self.step(self.reduce_scatter(grads), lr, metas)

    @torch.no_grad()
    def reduce_scatter(self, grads):
        """Stage 2+: each sharded leaf's gradient becomes this rank's
        slice of the average over the sharding group."""
        if self.stage < 2 or self.degree <= 1:
            return grads
        out = dict(grads)
        for k, g in grads.items():
            d = self.dims[k]
            if d is not None:
                out[k] = reduce_scatter_dim(g, d, self.group) / self.degree
        return out

    @torch.no_grad()
    def step(self, grads, lr, metas, keep=None):
        """Decay and update every parameter (sharded leaves on this
        rank's slice), then rebuild the full sharded parameters (stages
        1-2) or free them (stage 3)."""
        opt = self.optimizer
        own, own_grads = {}, {}
        for k in self.params:
            g = grads[k]
            d = self.dims[k]
            if d is not None and (self.stage < 2 or self.degree <= 1):
                g = self._slice(k, g)
            own[k] = self._own(k)
            own_grads[k] = g
        states = self.states
        if self.offload:
            dev = next(iter(self.params.values())).device
            states = self._move(states, lambda t: t.to(dev,
                                                       non_blocking=True))
        own_grads = opt.decay_gradients(own, own_grads, metas)
        opt.apply_gradients(own, own_grads, states, lr, metas, keep)
        if self.offload:
            self.states = self._move(states, _pin)
        if self.stage >= 3:
            self.release_params()
            return
        if self.degree > 1:
            for k, p in self.params.items():
                d = self.dims[k]
                if d is not None:
                    p.copy_(all_gather_cat(own[k], d, self.group))

    @staticmethod
    def _move(states, fn):
        return {k: {kk: fn(v) if isinstance(v, torch.Tensor) else v
                    for kk, v in st.items()}
                for k, st in states.items()}
