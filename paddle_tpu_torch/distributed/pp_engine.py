"""Pipeline engine of a `PipelineLayer` (counterpart of
paddle_tpu/distributed/pp_engine.py).

Two schedules, chosen as the reference chooses them
(``pp_engine.py:39-75``):

- "hetero" (pp > 1): the GPipe schedule of
  `fleet.meta_parallel.pipeline_spmd_hetero` over genuinely different
  per-stage programs. This rank keeps the sublayers of its stage of the
  layer's ``segment_parts`` (the others' parameters are freed when the
  schedule is built); a `SharedLayerDesc` layer used on several stages
  (a tied embedding) stays on every rank, and its gradient is summed
  over the stages that use it. Each boundary is one tensor, as in the
  reference's ring, whose shape and dtype every rank finds by running
  the whole layer once on a micro-batch when the schedule is built.
- "accum" (pp = 1, or when the hetero contract cannot be met): the
  whole layer on every rank, micro-batch gradients accumulated, with
  the reference's warning that nothing is pipelined. The contract, as
  the reference's ``_HeteroUnsupported`` cases: a `PipelineLayer` of
  ``num_stages`` equal to pp, a loss function, an optimizer without
  per-parameter trust ratios (not Lamb or LarsMomentum) or per-parameter
  overrides, no per-parameter `ClipGradByNorm`, and stage boundaries
  that are single tensors of one shape, the loss a scalar.

The loss is the mean over the micro-batches (``accumulate_steps`` of
them, each ``rows / accumulate_steps`` rows of the global batch, which
every rank reads whole as the reference's replicated input). Coupled
decay, clipping (the global norm over the stages, a shared table
counted once: `sharding.meshed_update`) and the update follow, as on
one device. Dropout masks hash the elements' global coordinates under a
seed per sublayer and step (`framework.random.DropoutLayout`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import engine as _engine
from .. import observe as _observe
from .. import resolve_device
from ..framework import random as _random
from .collective import broadcast
from .fleet.meta_parallel.pipeline_parallel import pipeline_spmd_hetero
from .fleet.meta_parallel.pp_layers import PipelineLayer, _SharedRef
from .parallel import device as _rank_device
from .sharding import ZeroSharding, meshed_update

__all__ = ["PipelineEngine"]


class _HeteroUnsupported(Exception):
    pass


class PipelineEngine:
    """Trains `pipeline_layer` over the hybrid group `hcg` (None: one
    process) on `device` (default: this rank's), dropout from an
    `RngState` of `seed` (the same on every rank). ``schedule`` is
    "hetero" or "accum" once the first batch has built it."""

    def __init__(self, pipeline_layer, optimizer, hcg, *,
                 micro_batch_size=1, accumulate_steps=1, loss_fn=None,
                 device=None, seed=0):
        self.layer = pipeline_layer
        self.optimizer = optimizer
        self.hcg = hcg
        self.micro_batch_size = micro_batch_size
        self.accumulate_steps = int(accumulate_steps)
        self.loss_fn = loss_fn or getattr(pipeline_layer, "_loss_fn", None)
        if device is None:
            device = _rank_device() if hcg is not None else None
        self.device = resolve_device(device)
        pipeline_layer.to(self.device)
        self.schedule = None
        self.rng = _random.RngState(seed, self.device)
        self._heads_split = _engine.heads_split(pipeline_layer)
        self._sigs = set()
        self.step = 0

    # -- building ------------------------------------------------------------
    def _build(self, x_mb, y_mb):
        pp = self.hcg.get_pipe_parallel_world_size() \
            if self.hcg is not None else 1
        if pp > 1:
            try:
                self._build_hetero(x_mb, y_mb)
                self.schedule = "hetero"
                return
            except _HeteroUnsupported as e:
                warnings.warn(
                    "PipelineEngine: heterogeneous ring schedule "
                    f"unavailable ({e}); FALLING BACK to gradient "
                    "accumulation — micro-batches will NOT overlap "
                    "across stages (no pipelining)")
        self.schedule = "accum"
        self._build_accum()

    def _check_contract(self):
        layer, opt = self.layer, self.optimizer
        if not isinstance(layer, PipelineLayer):
            raise _HeteroUnsupported("layer is not a PipelineLayer")
        pp = self.hcg.get_pipe_parallel_world_size()
        if layer._num_stages != pp:
            raise _HeteroUnsupported(
                f"num_stages {layer._num_stages} != pp degree {pp}")
        if self.loss_fn is None:
            raise _HeteroUnsupported("no loss_fn")
        if type(opt).__name__ in ("Lamb", "LarsMomentum"):
            raise _HeteroUnsupported(
                f"{type(opt).__name__} computes per-parameter trust "
                "ratios; packed stage rows would merge them")
        gc = opt._grad_clip
        if gc is not None and type(gc).__name__ == "ClipGradByNorm":
            raise _HeteroUnsupported(
                "per-leaf ClipGradByNorm cannot act on packed stage rows")
        for k, p in layer.named_parameters():
            m = opt._leaf_meta(p)
            if (m.get("lr_mult", 1.0) != 1.0 or "decoupled_coeff" in m
                    or "hyper_overrides" in m):
                raise _HeteroUnsupported(
                    f"per-param optimizer overrides on {k} cannot ride a "
                    "packed stage row")

    def _probe(self, x_mb, y_mb):
        """Run the whole layer once on a micro-batch (no gradients, a
        throwaway random state): the (shape, dtype) of each stage
        boundary, which must be one tensor of one shape, and a scalar
        loss."""
        layer = self.layer
        bounds = layer.segment_parts
        specs = []
        try:
            with torch.no_grad(), _random.rng_scope(
                    _random.RngState(0, self.device)):
                t = x_mb
                for i, sub in enumerate(layer.run_function):
                    t = sub(t)
                    if i + 1 in bounds[1:-1]:
                        if not isinstance(t, torch.Tensor):
                            raise _HeteroUnsupported(
                                f"stage {len(specs)} boundary is not a "
                                "single array")
                        specs.append((tuple(t.shape), t.dtype))
                loss = self.loss_fn(t, y_mb)
        except _HeteroUnsupported:
            raise
        except Exception as e:  # noqa: BLE001 - the reference's probe
            raise _HeteroUnsupported(f"stage probing failed: {e}")
        if any(s != specs[0] for s in specs):
            raise _HeteroUnsupported(
                f"inter-stage shapes differ: {specs[0]} vs "
                f"{next(s for s in specs if s != specs[0])}")
        if not (isinstance(loss, torch.Tensor) and loss.dim() == 0):
            raise _HeteroUnsupported(
                "loss_fn must reduce to a scalar per micro-batch")
        return specs

    def _build_hetero(self, x_mb, y_mb):
        self._check_contract()
        specs = self._probe(x_mb, y_mb)
        layer, hcg = self.layer, self.hcg
        st = hcg.get_stage_id()
        lo, hi = layer.segment_parts[st], layer.segment_parts[st + 1]
        self.local_ids = range(lo, hi)
        self.in_spec = specs[st - 1] if st > 0 else None
        self.out_spec = specs[st] if st < len(specs) else None
        subs = list(layer.run_function)
        shared = {id(base) for base in layer._shared.values()}
        # a shared layer stays on every rank when a stage other than its
        # own uses it (a _SharedRef on another stage)
        shared_ids = {i for i, sub in enumerate(subs) if id(sub) in shared}
        self._shapes = {}
        params, shared_names = {}, []
        for i, sub in enumerate(subs):
            if isinstance(sub, _SharedRef):
                continue
            keep = i in self.local_ids or i in shared_ids
            for name, p in sub.named_parameters():
                full = f"run_function.{i}.{name}"
                self._shapes[full] = (tuple(p.shape), layer.stage_of_layer(i))
                if not keep:
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
                elif p.requires_grad:
                    params[full] = p
                    if i in shared_ids:
                        shared_names.append(full)
        self.params = params
        self.shared_names = shared_names
        self._zero = ZeroSharding(params, self.optimizer, hcg, 0, False)
        self._metas = {k: self.optimizer._leaf_meta(p)
                       for k, p in params.items()}

    def _build_accum(self):
        self.params = {k: p for k, p in self.layer.named_parameters()
                       if p.requires_grad}
        self._states = {k: self.optimizer._init_state(p)
                        for k, p in self.params.items()}
        self._metas = {k: self.optimizer._leaf_meta(p)
                       for k, p in self.params.items()}

    @property
    def opt_state(self):
        if self.schedule == "hetero":
            return self._zero.states
        return getattr(self, "_states", None)

    # -- the step ------------------------------------------------------------
    def _micro(self, arr):
        t = torch.as_tensor(np.asarray(arr)) if not isinstance(
            arr, torch.Tensor) else arr
        if not t.is_floating_point():
            t = t.long()
        t = t.to(self.device)
        M = self.accumulate_steps
        if t.shape[0] % M:
            raise ValueError(f"global batch {t.shape[0]} not divisible by "
                             f"accumulate_steps {M}")
        return t.split(t.shape[0] // M)

    def _run(self, i, x):
        self.rng.layout.enter(1 + i)
        return self.layer.run_function[i](x)

    def train_batch(self, inputs, labels):
        """One step on the global batch; returns the mean loss over its
        micro-batches (a float32 0-dim device tensor, the same on every
        rank)."""
        xs, ys = self._micro(inputs), self._micro(labels)
        sig = _observe.signature_of({"inputs": [inputs],
                                     "labels": [labels]})
        compiling = sig not in self._sigs
        with _observe.phase("compile" if compiling else "device-step"):
            if compiling:
                _observe.record_compile("pp.train_step", signature=sig)
                self._sigs.add(sig)
            if self.schedule is None:
                self._build(xs[0], ys[0])
            for p in self.params.values():
                p.grad = None
            lay = _random.DropoutLayout(
                self.rng.next_seed(), seq_len=xs[0].shape[1]
                if xs[0].dim() >= 2 else None,
                heads_split=self._heads_split)
            self.rng.layout = lay
            try:
                with _random.rng_scope(self.rng):
                    loss = (self._hetero_step if self.schedule == "hetero"
                            else self._accum_step)(xs, ys, lay)
            finally:
                self.rng.layout = None
        self.step += 1
        return loss

    def _hetero_step(self, xs, ys, lay):
        M, hcg = self.accumulate_steps, self.hcg
        last = hcg.is_last_stage()
        n = len(self.layer.run_function)
        mb = xs[0].shape[0]

        def stage(m, x):
            t = xs[m] if x is None else x
            for i in self.local_ids:
                t = self._run(i, t)
            if last:
                lay.enter(1 + n)
                return self.loss_fn(t, ys[m]).float() / M
            return t

        def on_micro(m):
            lay.row0 = m * mb

        total = pipeline_spmd_hetero(hcg, M, stage, self.in_spec,
                                     self.out_spec, self.device,
                                     on_micro=on_micro)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        meshed_update(self._zero, grads,
                      self.optimizer._lr_scalar(self.device), self._metas,
                      pipeline_shared=self.shared_names,
                      grad_clip=self.optimizer._grad_clip)
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=self.device)
        return broadcast(total.float().contiguous(),
                         src=hcg.get_rank_from_stage(
                             hcg.get_pipe_parallel_world_size() - 1),
                         group=hcg.get_pipe_parallel_group())

    def _accum_step(self, xs, ys, lay):
        M, opt = self.accumulate_steps, self.optimizer
        total = None
        for m, (x, y) in enumerate(zip(xs, ys)):
            lay.row0 = m * x.shape[0]
            t = x
            for i in range(len(self.layer.run_function)):
                t = self._run(i, t)
            lay.enter(1 + len(self.layer.run_function))
            loss = self.loss_fn(t, y).float() / M
            loss.backward()
            total = loss.detach() if total is None else total + \
                loss.detach()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        grads = opt.decay_gradients(self.params, grads, self._metas)
        if opt._grad_clip is not None:
            grads = opt._grad_clip._clip_fn(grads, self.params)
        opt.apply_gradients(self.params, grads, self._states,
                            opt._lr_scalar(self.device), self._metas)
        return total

    @torch.no_grad()
    def sync_to_layer(self):
        """Make every rank's layer whole: under "hetero" each stage's
        parameters are broadcast from a rank of that stage over pp (the
        reference's layer holds every stage)."""
        if self.schedule != "hetero":
            return
        hcg = self.hcg
        named = dict(self.layer.named_parameters())
        for full, (shape, stage) in self._shapes.items():
            p = named[full]
            if p.numel() == 0:
                p.data = torch.empty(shape, dtype=p.dtype, device=p.device)
            if full in self.shared_names:
                continue
            broadcast(p.data, src=hcg.get_rank_from_stage(stage),
                      group=hcg.get_pipe_parallel_group())
