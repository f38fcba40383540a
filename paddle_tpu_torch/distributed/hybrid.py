"""Hybrid-parallel (dp x mp x pp x sharding) training of uniform-decoder
transformers (counterpart of paddle_tpu/distributed/hybrid.py).

The reference compiles the whole composition into one program: blocks
stacked ``[S, L/S, ...]`` over a 'pp' mesh axis, GSPMD collectives for
dp / mp, ZeRO by output shardings. Here each rank is a process with its
shards, and one step is, in order:

- its dp slice of the global batch (`sharding.dp_slice`), split into ``accumulate_steps``
  micro-batches;
- under pp > 1, the GPipe schedule of `fleet.meta_parallel.pipeline_spmd`
  over this rank's ``L / S`` blocks (the other blocks' parameters are
  freed when the engine is built); under pp = 1 the slice runs as one
  batch, as the reference's single stage runs on the merged micro axis;
- each micro-batch's loss divided by their count, so the loss is the
  mean over the global batch, as the reference's;
- the loss broadcast from the last stage and averaged over dp
  (`sharding.global_mean`);
- `sharding.meshed_update`: the gradient synchronisation
  (sequence-parallel parameters over mp, the replicated embeddings /
  final norm / tied head over pp, where the first and the last stage
  each hold part of the tied table's gradient, every gradient averaged
  over dp, in ``comm_dtype`` when given), then the step features of the
  single-card `Engine` over the grid (``loss_scale``, ``anomaly_guard``,
  the optimizer's ``grad_clip`` on the one device's norms) and the ZeRO
  update.

A loss weighted by a count (ERNIE's MLM rows that are not ignored)
divides by the count of the whole global batch: a criterion with a
``loss_weight(labels)`` method gives it, and every micro-batch's loss
is a part of it (`sharding.global_batch`), as the reference's head over
the whole batch computes it. Each step's dropout masks hash the
elements' global coordinates under a seed per site (the embeddings,
each block by its global index, the head): a factorization drops the
same elements as world size 1 (`framework.random.DropoutLayout`).

With ``FLAGS_lowp_matmul`` on the blocks' linears quantise with dynamic
scales (there is no delayed-scaling region, as in the reference's
per-block scan) on kernel B9, on their shards under mp > 1 with scales
agreed over the mp group, and so does GPT's tied head
(``hybrid.py:531-542``). Each new batch signature records one
``hybrid_step`` compile event.
"""

from __future__ import annotations

import re
import time
from collections import OrderedDict

import contextlib

import numpy as np
import torch

from .. import amp as _amp
from .. import engine as _engine
from .. import observe as _observe
from .. import profiler as _profiler
from .. import resolve_device
from ..framework import flags as _flags
from ..framework import random as _random
from ..ops import lowp as _lowp
from .collective import all_reduce, broadcast
from .fleet.meta_parallel.pipeline_parallel import pipeline_spmd
from .parallel import device as _rank_device
from .sharding import ZeroSharding, check_waiting_flags, dp_slice, \
    global_batch, global_mean, meshed_update
from .topology import DP_AXIS, MP_AXIS, PP_AXIS, SHARDING_AXIS

__all__ = ["split_uniform_params", "HybridParallelEngine", "values_sub",
           "make_gpt_hybrid_engine", "make_ernie_hybrid_engine"]


def split_uniform_params(layer, block_prefix_re):
    """Split `layer`'s parameters into the blocks' and the rest.

    `block_prefix_re` has one group for the layer index and one for the
    name within the block (``r"gpt\\.layers\\.(\\d+)\\.(.*)"``). Returns
    ``(blocks, rest, num_layers)``: blocks ``{name in block: [parameter
    of layer 0, 1, ...]}``, rest ``{name: parameter}``."""
    pat = re.compile(block_prefix_re)
    per_layer, rest = {}, OrderedDict()
    for name, p in layer.named_parameters():
        m = pat.match(name)
        if m:
            per_layer.setdefault(m.group(2), {})[int(m.group(1))] = p
        else:
            rest[name] = p
    num_layers = 0
    blocks = OrderedDict()
    for sub, by_idx in per_layer.items():
        num_layers = max(num_layers, max(by_idx) + 1)
        blocks[sub] = [by_idx[i] for i in sorted(by_idx)]
    return blocks, rest, num_layers


def values_sub(values, prefix):
    return {k[len(prefix):]: v for k, v in values.items()
            if k.startswith(prefix)}


class HybridParallelEngine:
    """Hybrid training of a model with uniform blocks.

    `blocks`: the model's L block modules, in order (`block_regex` names
    their parameters); `embed_fn(model, ids)` -> the first stage's
    activation; `head_fn(model, h, labels)` -> the scalar loss of the
    last stage's activation; `act_shape(ids)` -> the shape of the
    activation a stage hands to the next for a micro-batch of `ids`.
    Training runs on `device` (default: this rank's, from
    `init_parallel_env`), dropout from an `RngState` of `seed` (the
    same on every rank). ``loss_scale``, ``anomaly_guard`` and
    ``comm_dtype`` as `engine.Engine` takes them (their state in
    `buffers` under the reference's names); clipping is the optimizer's
    ``grad_clip``. The guard counts consecutive bad steps and, after
    ``FLAGS_anomaly_max_bad_steps`` of them, raises: the reference's
    hybrid engine has no guard and so no rollback; its state is saved
    and restored by `checkpoint.save_hybrid_state` /
    `load_hybrid_state`."""

    def __init__(self, model, criterion, optimizer, hcg, *, block_regex,
                 blocks, embed_fn, head_fn, act_shape,
                 accumulate_steps=1, zero_stage=0, offload=False,
                 device=None, seed=0, loss_scale=None, anomaly_guard=False,
                 comm_dtype=None):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.hcg = hcg
        self.accumulate_steps = int(accumulate_steps)
        self.zero_stage = zero_stage
        self.offload = offload
        self.block_regex = block_regex
        self.embed_fn, self.head_fn = embed_fn, head_fn
        self.act_shape = act_shape
        if device is None:
            device = _rank_device()
        self.device = resolve_device(device)
        model.to(self.device)
        check_waiting_flags()
        self.comm_dtype = _engine.mesh_comm_dtype(comm_dtype)
        self.anomaly_guard = bool(anomaly_guard)
        self.buffers = {}
        self._scale_cfg, self._dynamic, self._static_scale, \
            self._record_grad_norm = _engine.step_buffers(
                self.buffers, loss_scale, anomaly_guard, self.device)

        block_params, rest, L = split_uniform_params(model, block_regex)
        S = hcg.get_pipe_parallel_world_size()
        if L % S:
            raise ValueError(f"num_layers {L} % pp {S} != 0")
        self.num_layers, self.pp = L, S
        self.layers_per_stage = L // S
        first = hcg.get_stage_id() * self.layers_per_stage
        self.local_ids = range(first, first + self.layers_per_stage)
        self.blocks = [blocks[i] for i in self.local_ids]
        pat = re.compile(block_regex)
        params = OrderedDict()
        for name, p in model.named_parameters():
            m = pat.match(name)
            if m and int(m.group(1)) not in self.local_ids:
                # another stage's block: this rank never holds it
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            elif p.requires_grad:
                params[name] = p
        self.params = params
        self._shapes = {k: tuple(p.shape) for k, p in params.items()}
        self.rest_names = [k for k in rest if k in params]
        stage = zero_stage if hcg.get_sharding_parallel_world_size() > 1 \
            else 0
        self._zero = ZeroSharding(params, optimizer, hcg, stage, offload)
        self._metas = {k: optimizer._leaf_meta(p) for k, p in params.items()}
        self._heads_split = _engine.heads_split(model)
        self.rng = _random.RngState(seed, self.device)
        self._sigs = set()
        self._last_batch = None
        self._mem = {}
        self._mem_key = None
        self.step = 0

    @property
    def opt_state(self):
        """This rank's optimizer state (its ZeRO slices)."""
        return self._zero.states

    # -- the step ------------------------------------------------------------
    def _rank_part(self, x):
        x = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        return dp_slice(x, self.hcg).long().to(self.device)

    def _run_blocks(self, x):
        lay = self.rng.layout
        for i, block in zip(self.local_ids, self.blocks):
            lay.enter(1 + i)            # block i's dropout sites
            x = block(x)
        return x

    def _embed(self, tokens):
        self.rng.layout.enter(0)
        return self.embed_fn(self.model, tokens)

    def _head(self, y, labels):
        self.rng.layout.enter(1 + self.num_layers)
        return self.head_fn(self.model, y, labels)

    def _forward_backward(self, tokens, labels, scale):
        """Forward and backward of this rank's slice (its loss times
        `scale` when given); the summed loss of the last stage (None
        elsewhere)."""
        M = self.accumulate_steps
        if self.pp == 1:
            loss = self._head(self._run_blocks(self._embed(tokens)), labels)
            (loss if scale is None else loss * scale).backward()
            return loss.detach()
        if tokens.shape[0] % M:
            raise ValueError(f"dp slice of {tokens.shape[0]} rows does not "
                             f"split into {M} micro-batches")
        mb = tokens.shape[0] // M
        ids = tokens.split(mb)
        lbls = labels.split(mb)
        lay = self.rng.layout
        row0 = lay.row0
        act_dtype = next(iter(self.params.values())).dtype

        def on_micro(m):
            lay.row0 = row0 + m * mb    # micro-batch m's global rows

        return pipeline_spmd(
            self.hcg, M,
            embed=lambda m: self._embed(ids[m]),
            blocks=self._run_blocks,
            head=lambda y, m: self._head(y, lbls[m]) / M,
            act_shape=self.act_shape(ids[0]), act_dtype=act_dtype,
            device=self.device, loss_scale=scale, on_micro=on_micro)

    def train_batch(self, tokens, labels):
        """One step on the GLOBAL batch; returns the mean loss over it
        (a float32 0-dim device tensor, the same on every rank)."""
        t0 = time.perf_counter()
        tok, lbl = self._rank_part(tokens), self._rank_part(labels)
        self._last_batch = (tokens, labels)
        sig = _observe.signature_of({"inputs": [tokens],
                                     "labels": [labels]})
        compiling = sig not in self._sigs
        mem_key = (sig, _lowp.mode())
        measure = self.device.type == "cuda" and mem_key not in self._mem
        with _observe.phase("compile" if compiling else "device-step"):
            if compiling:
                _observe.record_compile("hybrid_step", signature=sig)
                self._sigs.add(sig)
            if measure:
                torch.cuda.reset_peak_memory_stats(self.device)
                base = torch.cuda.memory_allocated(self.device)
            loss = self._step(tok, lbl)
            if measure:
                peak = torch.cuda.max_memory_allocated(self.device)
                self._mem[mem_key] = {"arguments": base, "peak": peak,
                                      "temps": max(peak - base, 0)}
        self._mem_key = mem_key
        if compiling:
            _observe.annotate("hybrid_step",
                              wall_s=time.perf_counter() - t0)
        self.step += 1
        if self.anomaly_guard:
            self._check_anomaly()
        return loss

    def _known_weight(self, labels):
        """(total, parts) of a count-weighted criterion over the global
        batch (`sharding.global_batch`), or None."""
        weight_of = getattr(self.criterion, "loss_weight", None)
        if weight_of is None or not self.hcg.is_last_stage():
            return None
        total = weight_of(labels).detach().float().reshape(1).clone()
        dp = self.hcg.get_data_parallel_world_size()
        if dp > 1:
            all_reduce(total, group=self.hcg.get_data_parallel_group())
        parts = dp * (self.accumulate_steps if self.pp > 1 else 1)
        return total[0], parts

    def _step(self, tok, lbl):
        hcg = self.hcg
        self._zero.gather_params()
        for p in self.params.values():
            p.grad = None
        scale = self.buffers[_engine.LOSS_SCALE_KEY] if self._dynamic \
            else self._static_scale
        # comm_dtype: the forward under O2 autocast of that dtype, as the
        # meshed Engine's
        amp_ctx = _amp.auto_cast(enable=True, level="O2",
                                 dtype=self.comm_dtype) \
            if self.comm_dtype is not None else contextlib.nullcontext()
        self.rng.layout = _engine.dropout_layout(
            self.rng, hcg, tok.shape[0], tok.shape[1], self._heads_split)
        try:
            with _random.rng_scope(self.rng), amp_ctx, \
                    _lowp.engine_scope(), \
                    global_batch(hcg, self._known_weight(lbl)):
                total = self._forward_backward(tok, lbl, scale)
        finally:
            self.rng.layout = None
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        if self.pp > 1:
            if total is None:
                total = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
            total = broadcast(total.float().contiguous(),
                              src=hcg.get_rank_from_stage(self.pp - 1),
                              group=hcg.get_pipe_parallel_group())
        loss = global_mean(total, hcg)
        finite, guard_ok, gnorm = meshed_update(
            self._zero, grads, self.optimizer._lr_scalar(self.device),
            self._metas, pipeline_shared=self.rest_names
            if self.pp > 1 else (), scale=scale,
            loss=loss if self.anomaly_guard else None,
            grad_clip=self.optimizer._grad_clip, comm_dtype=self.comm_dtype,
            record_norm=self._record_grad_norm)
        bufs = self.buffers
        if self.anomaly_guard:
            prev = bufs[_engine.ANOMALY_BAD_STEPS_KEY]
            bufs[_engine.ANOMALY_BAD_STEPS_KEY] = torch.where(
                guard_ok, torch.zeros_like(prev), prev + 1)
        if gnorm is not None:
            bufs[_engine.GRAD_NORM_KEY] = gnorm
        if self._dynamic:
            _engine.update_loss_scale(bufs, self._scale_cfg, finite)
        return loss

    def _check_anomaly(self):
        """The guard's host read, every ``FLAGS_anomaly_check_interval``
        steps: past ``FLAGS_anomaly_max_bad_steps`` consecutive bad
        steps it raises (the reference's hybrid engine has no rollback
        to port)."""
        interval = _flags.flag("FLAGS_anomaly_check_interval")
        if interval > 1 and self.step % interval:
            return
        bad = int(self.buffers[_engine.ANOMALY_BAD_STEPS_KEY])
        max_bad = _flags.flag("FLAGS_anomaly_max_bad_steps")
        if bad and max_bad and bad >= max_bad:
            from ..framework.errors import PreconditionNotMetError

            raise PreconditionNotMetError(
                f"anomaly guard: {bad} consecutive non-finite steps; the "
                "hybrid engine has no rollback (the reference's "
                "HybridParallelEngine has no guard and no rollback): "
                "restore a checkpoint of distributed.checkpoint."
                "save_hybrid_state with load_hybrid_state")

    def sync_to_layer(self):
        """ZeRO-3: all-gather the parameters into the model (they rest as
        slices between steps)."""
        self._zero.gather_params()

    # -- step introspection --------------------------------------------------
    def _spec(self, name, p):
        """The reference-style partition spec of a parameter: the axis
        each dimension is split over (None: whole)."""
        spec = [None] * len(self._shapes[name])
        split = getattr(p, "split_axis", None)
        if split is not None:
            spec[split] = MP_AXIS
        d = self._zero.dims.get(name)
        if self._zero.stage >= 3 and d is not None:
            spec[d] = SHARDING_AXIS
        return tuple(spec)

    def schedule(self):
        """The ordered phases of one step on this rank (embed, its
        blocks, head, gradient reduction, optimizer), each with its
        parameters' partition specs; metadata only, no device work."""
        pat = re.compile(self.block_regex)
        block_specs, embed, head = OrderedDict(), OrderedDict(), \
            OrderedDict()
        for k, p in self.params.items():
            m = pat.match(k)
            if m:
                if int(m.group(1)) == self.local_ids[0]:
                    block_specs[m.group(2)] = (PP_AXIS,) + self._spec(k, p)
            elif "embedding" in k:
                embed[k] = self._spec(k, p)
            else:
                head[k] = self._spec(k, p)
        stage = self.hcg.get_stage_id()
        phases = [dict(name="embed", kind="embed", params=embed)]
        for i in range(self.num_layers):
            phases.append(dict(name=f"block{i}", kind="block",
                               stage=i // self.layers_per_stage,
                               params=block_specs if i in self.local_ids
                               else OrderedDict()))
        phases.append(dict(name="head", kind="head", params=head))
        axes = [DP_AXIS]
        if self.pp > 1:
            axes.insert(0, PP_AXIS)
        if self._zero.stage >= 2 and self._zero.degree > 1:
            axes.append(SHARDING_AXIS)
        phases.append(dict(name="grad-reduce", kind="collective",
                           axes=tuple(axes), params=OrderedDict()))
        opt = OrderedDict()
        for k, st in self._zero.states.items():
            # the dimension each state leaf is sharded along (None: whole)
            opt[k] = {kk: self._zero.dims[k] for kk in st}
        phases.append(dict(name="opt", kind="opt", stage=stage,
                           params=opt))
        return phases

    def memory_analysis(self):
        """The device memory of the first step at the last step's batch
        signature and precision, measured on the card as it ran
        (``arguments``: bytes allocated before it, ``peak``: its
        high-water mark, ``temps``: the difference)."""
        if self._mem_key is None:
            raise RuntimeError("run train_batch() once first")
        if self.device.type != "cuda":
            raise RuntimeError("memory_analysis measures the card's "
                               f"allocator; this engine runs on "
                               f"{self.device}")
        return dict(self._mem[self._mem_key])

    def attribute_step(self, logdir=None, steps=1, top=10):
        """Capture `steps` replays of the last batch (real steps) under
        the port's profiler and classify their device time into the
        observe buckets (`observe.attribute`)."""
        if self._last_batch is None:
            raise RuntimeError("run train_batch() once first")
        if logdir is None:
            import tempfile

            logdir = tempfile.mkdtemp(prefix="paddle-attrib-")
        tokens, labels = self._last_batch
        _profiler.start_trace(logdir, device=self.device)
        try:
            for _ in range(steps):
                self.train_batch(tokens, labels)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            _profiler.stop_trace()
        return _observe.attribute(logdir, top=top)


# -- adapters for the nlp model family --------------------------------------


def make_gpt_hybrid_engine(model, criterion, optimizer, hcg, *,
                           accumulate_steps=1, zero_stage=0,
                           offload=False, device=None, seed=0,
                           loss_scale=None, anomaly_guard=False,
                           comm_dtype=None):
    """The hybrid engine of a `GPTForPretraining` built under `hcg`
    (``use_parallel=True`` for mp > 1)."""
    gpt = model.gpt
    cfg = model.config
    mp = gpt.mp_group.nranks if gpt.mp_group is not None else 1

    def embed_fn(m, ids):
        return m.gpt.embed(ids)

    def head_fn(m, h, labels):
        h = m.gpt.final_norm(h)
        mode = _lowp.mode()
        if mode == "off":
            return criterion(m.logits(h), labels)
        # dynamic scales: the per-block stages have no delayed-scaling
        # region (the ScaleState rides the plain Engine); the table's
        # abs-max over all its rows
        h = m.head_input(h)
        wt = m.gpt.embeddings.word_embeddings.weight.t()
        with _lowp.shard_groups(b=m.gpt.mp_group):
            sa, sb = _lowp.operand_scales(h, wt)
        logits = _lowp.scaled_matmul(h, wt, sa, sb, qdtype=mode,
                                     out_dtype=torch.result_type(h, wt))
        return criterion(logits, labels)

    def act_shape(ids):
        s = ids.shape[1] // mp if gpt.sequence_parallel else ids.shape[1]
        return (ids.shape[0], s, cfg.hidden_size)

    return HybridParallelEngine(
        model, criterion, optimizer, hcg,
        block_regex=r"gpt\.layers\.(\d+)\.(.*)", blocks=gpt.layers,
        embed_fn=embed_fn, head_fn=head_fn, act_shape=act_shape,
        accumulate_steps=accumulate_steps, zero_stage=zero_stage,
        offload=offload, device=device, seed=seed, loss_scale=loss_scale,
        anomaly_guard=anomaly_guard, comm_dtype=comm_dtype)


def make_ernie_hybrid_engine(model, criterion, optimizer, hcg, *,
                             accumulate_steps=1, zero_stage=0,
                             offload=False, device=None, seed=0,
                             loss_scale=None, anomaly_guard=False,
                             comm_dtype=None):
    """The hybrid engine of an `ErnieForPretraining` built under `hcg`
    (``use_parallel=True`` for mp > 1), as the reference's
    (``hybrid.py:556-588``): the embeddings are the first stage's
    input, the encoder blocks the pipelined stack, and the pooler with
    the MLM and NSP heads the last stage's loss; the MLM decoder is the
    word table itself (its gradient summed over the stages that use
    it). The criterion takes the MLM labels only (the NSP head runs and
    takes no gradient, as in the reference's MLM-only hybrid path)."""
    ernie = model.ernie
    cfg = model.config
    mp = ernie.mp_group.nranks if ernie.mp_group is not None else 1

    def embed_fn(m, ids):
        return m.ernie.embed(ids)

    def head_fn(m, h, labels):
        scores, rel = m.cls(h, m.ernie.pool(h))
        return criterion(scores, rel, labels)

    def act_shape(ids):
        s = ids.shape[1] // mp if ernie.sequence_parallel else ids.shape[1]
        return (ids.shape[0], s, cfg.hidden_size)

    return HybridParallelEngine(
        model, criterion, optimizer, hcg,
        block_regex=r"ernie\.encoder\.(\d+)\.(.*)", blocks=ernie.encoder,
        embed_fn=embed_fn, head_fn=head_fn, act_shape=act_shape,
        accumulate_steps=accumulate_steps, zero_stage=zero_stage,
        offload=offload, device=device, seed=seed, loss_scale=loss_scale,
        anomaly_guard=anomaly_guard, comm_dtype=comm_dtype)
