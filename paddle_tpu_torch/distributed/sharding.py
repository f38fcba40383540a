"""The meshed step's rules, shared by the port's meshed engines
(`engine.Engine(mesh=)`, `hybrid.HybridParallelEngine` and
`pp_engine.PipelineEngine`): the dp
slice of the global batch, gradient synchronisation, ZeRO and the loss
over the global batch (the reference expresses them as shardings in its
compiled step: ``engine.py:212-267`` and
``distributed/hybrid.py:130-166``).

Each rank takes its dp slice of the global batch (`dp_slice`), holds
its model-parallel shards and runs forward and backward eagerly; then,
in this order (`meshed_update`):

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

`meshed_update` is the tail the engines run after the backward, in
the reference's order (``engine.py:402-520``): steps 1-3, then the
step features of the single-card `Engine`, each over the whole grid:

- loss scaling: the gradients are unscaled, and whether they are
  finite is reduced (max of "some element is not") over every axis of
  the grid, so every rank skips or applies the step together and the
  scale's counters stay equal;
- the anomaly guard: the same reduced verdict and the global loss;
- the global gradient norm (``FLAGS_record_grad_norm`` and
  `ClipGradByGlobalNorm`): `MeshNorm` sums the squares of a parameter
  split over mp over its shards, counts a replicated one once (on mp
  rank 0) and a pipeline-shared one once (on the first stage), and sums
  the stages' own blocks over pp; dp and ZeRO ranks hold the same
  gradients here (before the reduce-scatter), so nothing is summed over
  them. `ClipGradByNorm`'s per-parameter norm sums a split parameter's
  shards;
- coupled decay and clipping on the full gradients, then the ZeRO
  reduce-scatter and the update, ``where(keep, new, old)`` under a
  skipped step.

``comm_dtype`` reduces the dp gradients in that dtype (the reference's
fp16_allreduce strategy; its GSPMD step reduces the gradients that the
O2 backward computes in it).

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

from .collective import ReduceOp, all_gather_cat, all_reduce, \
    reduce_scatter_dim

__all__ = ["dp_slice", "global_mean", "global_batch", "batch_weight",
           "zero_dim", "sync_sequence_parallel_grads", "sync_grads",
           "ZeroSharding", "check_waiting_flags", "grid_groups",
           "grid_all_finite", "MeshNorm", "meshed_update"]

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
def global_batch(hcg, known=None):
    """While a meshed step computes its loss on this rank's dp slice:
    `batch_weight` answers for the global batch. `known`: ``(total,
    parts)`` when the step knows them beforehand (a pipeline's
    micro-batches, each a part of the global batch: the weight total of
    the whole global batch and dp x micro-batches)."""
    _GLOBAL_BATCH.append((hcg, known))
    try:
        yield
    finally:
        _GLOBAL_BATCH.pop()


def batch_weight(w):
    """``(total, parts)`` for a rank's loss weight `w` (a 0-dim tensor,
    e.g. a loss mask's sum): inside `global_batch`, the sum of `w` over
    dp and the dp degree (or what the step knew beforehand); elsewhere
    ``(w, 1)``. A loss ``num * parts / total`` averaged over the parts
    is then ``sum(num) / total``."""
    if not _GLOBAL_BATCH:
        return w, 1
    hcg, known = _GLOBAL_BATCH[-1]
    if known is not None:
        return known
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


def _all_reduce_coalesced(tensors, group, scale=None, dtype=None):
    """Sum `tensors` over `group` in one collective (in place; in
    `dtype` when given, else float32), then multiply by `scale` when
    given (in float32)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors or group.pg is None:
        if scale is not None:
            for t in tensors:
                t.mul_(scale)
        return
    flat = torch.cat([t.reshape(-1).to(dtype or torch.float32)
                      for t in tensors])
    all_reduce(flat, group=group)
    flat = flat.float()
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
def sync_grads(grads, params, hcg, pipeline_shared=(), comm_dtype=None):
    """Steps 1-3 of the module docstring, in place on the ``{name:
    grad}`` dict; `pipeline_shared` names the parameters to sum over
    pp; the dp reduction runs in `comm_dtype` when given."""
    sync_sequence_parallel_grads(grads, params, hcg)
    if hcg.get_pipe_parallel_world_size() > 1 and pipeline_shared:
        _all_reduce_coalesced([grads[k] for k in pipeline_shared],
                              hcg.get_pipe_parallel_group())
    dp = hcg.get_data_parallel_world_size()
    if dp > 1:
        _all_reduce_coalesced(
            list(grads.values()), hcg.get_data_parallel_group(), 1.0 / dp,
            dtype=None if comm_dtype is None else getattr(torch,
                                                          comm_dtype))


def grid_groups(hcg):
    """The hybrid grid's axis groups of more than one rank (dp, pp,
    sharding, mp): a reduction over each in turn covers the grid."""
    groups = (hcg.get_data_parallel_group(), hcg.get_pipe_parallel_group(),
              hcg.get_sharding_parallel_group(),
              hcg.get_model_parallel_group())
    return [g for g in groups if g is not None and g.pg is not None]


@torch.no_grad()
def grid_all_finite(grads, hcg):
    """A device bool, the same on every rank of the grid: every element
    of every rank's `grads` is finite."""
    from ..amp import all_finite

    bad = (~all_finite(list(grads.values()))).float().reshape(1)
    for g in grid_groups(hcg):
        all_reduce(bad, ReduceOp.MAX, group=g)
    return bad[0] == 0


class MeshNorm:
    """Gradient norms over the grid as one device holding every
    parameter would take them (see the module docstring). `params` is
    this rank's ``{name: Parameter}``; `pipeline_shared` names the
    parameters replicated over pp (their gradients summed over it)."""

    def __init__(self, params, hcg, pipeline_shared=()):
        self.hcg = hcg
        self.mp_group = hcg.get_model_parallel_group()
        self.pp_group = hcg.get_pipe_parallel_group()
        first_mp = hcg.get_model_parallel_rank() == 0
        first_pp = hcg.get_stage_id() == 0
        shared = set(pipeline_shared)
        self.device = next(iter(params.values())).device
        self.split = {k for k, p in params.items()
                      if getattr(p, "split_axis", None) is not None}
        # a parameter counts in the total on the ranks that own it
        self.owned = {k for k in params
                      if (k in self.split or first_mp)
                      and (k not in shared or first_pp)}

    @torch.no_grad()
    def param_sq(self, sq):
        """``{name: this rank's sum of squares}`` -> each parameter's
        sum of squares over its whole logical tensor (a split one's
        summed over mp)."""
        split = [k for k in sq if k in self.split]
        if not split or self.mp_group is None or self.mp_group.pg is None:
            return dict(sq)
        flat = torch.stack([sq[k].float() for k in split])
        all_reduce(flat, group=self.mp_group)
        out = dict(sq)
        out.update(zip(split, flat.unbind(0)))
        return out

    @torch.no_grad()
    def total_sq(self, sq):
        """The sum of squares of every gradient of the grid, each
        parameter counted once: a float32 0-dim device tensor, the same
        on every rank."""
        parts = [sq[k].float() for k in sq if k in self.owned]
        total = torch.stack(parts).sum().reshape(1) if parts else \
            torch.zeros(1, dtype=torch.float32, device=self.device)
        for g in (self.mp_group, self.pp_group):
            if g is not None and g.pg is not None:
                all_reduce(total, group=g)
        return total[0]


def _sq_sums(grads):
    return {k: torch.sum(torch.square(g.float())) for k, g in grads.items()}


def meshed_update(zero, grads, lr, metas, *, pipeline_shared=(),
                  scale=None, loss=None, grad_clip=None, comm_dtype=None,
                  record_norm=False):
    """The meshed step's tail on this rank's ``{name: grad}`` (see the
    module docstring): gradient synchronisation, loss unscaling by
    `scale` (a device scalar, or None), the guard's verdict when `loss`
    (the global loss) is given, decay, `grad_clip`, the ZeRO update.
    Returns ``(finite, guard_ok, grad_norm)``: the reduced finiteness of
    the unscaled gradients (None without a scale), the guard's verdict
    (None without a loss) and the raw gradients' global norm (None
    unless `record_norm`)."""
    hcg, params, opt = zero.hcg, zero.params, zero.optimizer
    sync_grads(grads, params, hcg, pipeline_shared, comm_dtype)
    finite = guard_ok = gnorm = keep = None
    if scale is not None:
        grads = {k: g / scale for k, g in grads.items()}
        finite = keep = grid_all_finite(grads, hcg)
    if loss is not None:
        ok = finite if finite is not None else grid_all_finite(grads, hcg)
        guard_ok = keep = ok & torch.isfinite(loss)
    norm = MeshNorm(params, hcg, pipeline_shared)
    if record_norm:
        gnorm = torch.sqrt(norm.total_sq(_sq_sums(grads)))
    grads = opt.decay_gradients(params, grads, metas)
    if grad_clip is not None:
        grads = grad_clip._clip_fn(grads, params, norm=norm)
    zero.step(zero.reduce_scatter(grads), lr, metas, keep)
    return finite, guard_ok, gnorm


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
        """Update every parameter from its (decayed) gradient, sharded
        leaves on this rank's slice, then rebuild the full sharded
        parameters (stages 1-2) or free them (stage 3). `keep` as the
        optimizer's ``apply_gradients``."""
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
