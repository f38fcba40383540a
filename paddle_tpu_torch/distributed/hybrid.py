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
- `sharding.sync_grads` (sequence-parallel parameters over mp, the
  replicated embeddings / final norm / tied head over pp, where the
  first and the last stage each hold part of the tied table's
  gradient, every gradient averaged over dp), then the ZeRO update
  (both `sharding.ZeroSharding.update`);
- the loss broadcast from the last stage and averaged over dp
  (`sharding.global_mean`).

With ``FLAGS_lowp_matmul`` on (world size 1: under mp > 1 the route
waits) the blocks' linears quantise with dynamic scales (there is no
delayed-scaling region, as in the reference's per-block scan) on kernel
B9, and so does the tied head (``hybrid.py:531-542``). Each new batch
signature records one ``hybrid_step`` compile event.
"""

from __future__ import annotations

import re
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import observe as _observe
from .. import profiler as _profiler
from .. import resolve_device
from ..framework import random as _random
from ..ops import lowp as _lowp
from .collective import broadcast
from .fleet.meta_parallel.pipeline_parallel import pipeline_spmd
from .parallel import device as _rank_device
from .sharding import ZeroSharding, check_waiting_flags, dp_slice, \
    global_mean
from .topology import DP_AXIS, MP_AXIS, PP_AXIS, SHARDING_AXIS

__all__ = ["split_uniform_params", "HybridParallelEngine", "values_sub",
           "make_gpt_hybrid_engine"]


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
    same on every rank)."""

    def __init__(self, model, criterion, optimizer, hcg, *, block_regex,
                 blocks, embed_fn, head_fn, act_shape,
                 accumulate_steps=1, zero_stage=0, offload=False,
                 device=None, seed=0):
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
        if optimizer._grad_clip is not None:
            raise NotImplementedError(
                "gradient clipping in the hybrid engine waits in ROADMAP "
                "queue A item 4")
        check_waiting_flags()

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
        for block in self.blocks:
            x = block(x)
        return x

    def _forward_backward(self, tokens, labels):
        """Forward and backward of this rank's slice; the summed loss
        of the last stage (None elsewhere)."""
        model, M = self.model, self.accumulate_steps
        if self.pp == 1:
            loss = self.head_fn(model, self._run_blocks(
                self.embed_fn(model, tokens)), labels)
            loss.backward()
            return loss.detach()
        if tokens.shape[0] % M:
            raise ValueError(f"dp slice of {tokens.shape[0]} rows does not "
                             f"split into {M} micro-batches")
        mb = tokens.shape[0] // M
        ids = tokens.split(mb)
        lbls = labels.split(mb)
        act_dtype = next(iter(self.params.values())).dtype
        return pipeline_spmd(
            self.hcg, M,
            embed=lambda m: self.embed_fn(model, ids[m]),
            blocks=self._run_blocks,
            head=lambda y, m: self.head_fn(model, y, lbls[m]) / M,
            act_shape=self.act_shape(ids[0]), act_dtype=act_dtype,
            device=self.device)

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
        return loss

    def _step(self, tok, lbl):
        self._zero.gather_params()
        for p in self.params.values():
            p.grad = None
        with _random.rng_scope(self.rng), _lowp.engine_scope():
            total = self._forward_backward(tok, lbl)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        self._zero.update(grads, self.optimizer._lr_scalar(self.device),
                          self._metas,
                          self.rest_names if self.pp > 1 else ())
        hcg = self.hcg
        if self.pp > 1:
            if total is None:
                total = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
            total = broadcast(total.float().contiguous(),
                              src=hcg.get_rank_from_stage(self.pp - 1),
                              group=hcg.get_pipe_parallel_group())
        return global_mean(total, hcg)

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
                           offload=False, device=None, seed=0):
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
        if mode != "off":
            # dynamic scales: the per-block stages have no delayed-
            # scaling region (the ScaleState rides the plain Engine)
            w = m.gpt.embeddings.word_embeddings.weight
            logits = _lowp.scaled_matmul(
                h, w.t(), qdtype=mode, out_dtype=torch.result_type(h, w))
        else:
            logits = m.logits(h)
        return criterion(logits, labels)

    def act_shape(ids):
        s = ids.shape[1] // mp if gpt.sequence_parallel else ids.shape[1]
        return (ids.shape[0], s, cfg.hidden_size)

    return HybridParallelEngine(
        model, criterion, optimizer, hcg,
        block_regex=r"gpt\.layers\.(\d+)\.(.*)", blocks=gpt.layers,
        embed_fn=embed_fn, head_fn=head_fn, act_shape=act_shape,
        accumulate_steps=accumulate_steps, zero_stage=zero_stage,
        offload=offload, device=device, seed=seed)


def make_ernie_hybrid_engine(*args, **kwargs):
    raise NotImplementedError(
        "make_ernie_hybrid_engine (with ERNIE's use_parallel) waits in "
        "ROADMAP queue A item 4")
