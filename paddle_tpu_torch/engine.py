"""Training engine (counterpart of paddle_tpu/engine.py's `Engine`).

``Engine(layer, optimizer, loss_fn).train_batch(inputs, labels)`` runs
one step eagerly, in the reference's order: forward and loss (the loss
in float32), backward, coupled weight decay, gradient clipping, then the
optimizer's update (``engine.py:414-520`` of the reference). Dropout
draws from the engine's own `framework.random.RngState` on its device,
installed for the forward with `rng_scope`. There is no compile
step: PyTorch runs each op as it comes. Each step runs under the
reference's `observe.phase` spans (``host-prep``, ``compile`` /
``device-step``, ``anomaly-readback``; host wall time, no
synchronisation), and the first step at a new batch signature (shapes
and dtypes of the host batch) records one ``train_step`` event in
`observe.retrace` — under `observe.no_retrace()` it raises
`RetraceError` before the step touches any state. `attribute_step` /
`overlap_report` replay the last batch under a `profiler` capture and
bucket its device time.

``loss_scale`` (None, a float, "dynamic" or a dict of GradScaler knobs)
scales the loss and unscales the gradients, and ``anomaly_guard``
counts non-finite steps, both with the reference's semantics:
finiteness is judged on the raw unscaled gradients before decay and
clipping (the guard also counts the loss itself), and a bad step keeps
the parameters, moments and buffers by a device-side ``torch.where``,
with no host synchronisation: the optimizer writes ``where(keep, new,
old)`` from the values it has loaded, and only the model's buffers
(which the forward may update in place) are copied beforehand.
The dynamic scale, its good / bad step counters and the guard's
consecutive-bad-step counter are device scalars in ``state.buffers``
under the reference's reserved names.

``comm_dtype`` ("bfloat16" / "float16", the reference's fp16_allreduce
knob on one card) runs each step's forward and loss under
``auto_cast(level="O2", dtype=comm_dtype)`` while the parameters and
the optimizer state stay float32 (their gradients come back in f32
through the casts); loss scaling and recompute compose with it as
without it (a recomputed block replays its first run's casts).

``FLAGS_lowp_matmul`` is latched at construction, as in the reference:
when it is on, ``state.buffers[LOWP_SCALE_KEY]`` holds a
`quantization.scaling.ScaleState` and each forward runs inside
`ops.lowp.engine_scope` (routed linears quantize on kernel B9) and
`ops.lowp.scale_region` (their operands take delayed scales from the
state's slots, in call order); the updated state replaces it after the
step, and a step the guard rejects keeps the previous one.

Every ``FLAGS_anomaly_check_interval`` steps a guarded engine reads the
counter back to the host once (the guard's only host synchronisation;
an unguarded engine never waits for the card), and after
``FLAGS_anomaly_max_bad_steps`` consecutive bad steps it rolls back to
the newest readable checkpoint of the manager given to
`attach_checkpoint_manager` (``distributed.checkpoint``; a flight note
and a black-box dump first, `PreconditionNotMetError` with no manager),
then re-arms the counter. Each step passes the ``train.batch`` fault
site with the host batch (``framework.faults``) and appends one
flight-recorder record (``observe.flight``): the loss, the step's host
wall time, the guard's counter, the pre-clip global gradient norm under
``FLAGS_record_grad_norm`` (``GRAD_NORM_KEY``, a device scalar in
``state.buffers``, latched at construction) and, on a card, the bytes
in use under ``FLAGS_flight_record_memory``; the device values stay
tensors until a dump. Buffer donation is not ported.

``mesh`` (``hcg.get_mesh()`` of the hybrid group `fleet.init` built)
trains a model built under that group, as the reference's meshed step
does: `train_batch` takes the GLOBAL batch and, with ``batch_spec``
naming "dp" (``"dp"`` or ``("dp",)``), each rank its dp
slice of it; after the backward the gradients are synchronised and
the update runs under ZeRO ``zero_stage`` over ``sharding_axis``
("sharding", or "dp" as the reference allows), with ``offload``
keeping the optimizer state in pinned host memory
(`distributed.sharding`); the loss returned is the mean
over the global batch, a masked loss's too (`sharding.global_batch`).
Every step feature works under a mesh as on one card, over the whole
grid (`sharding.meshed_update`): loss scaling (static, "dynamic" or a
dict) with its finiteness reduced over every axis, so all ranks skip or
apply a step together; the anomaly guard on that verdict and the global
loss; gradient clipping and ``FLAGS_record_grad_norm`` on the norms one
device would take; ``comm_dtype`` (the fp16_allreduce strategy: with
``fleet``'s ``strategy.fp16_allreduce`` on and no ``comm_dtype`` the
engine takes float16) with the dp gradients reduced in that dtype.
Each step's dropout masks are hashes of the elements' global
coordinates (`framework.random.DropoutLayout`), so a factorization
drops the same elements as the same engine at world size 1. The
guard rolls a meshed engine back as one: every rank reaches the same
verdict at the same step, restores the same step (the newest step every
rank can read, agreed over the world, or a `GangCheckpointManager`'s
newest globally committed one) and keeps its slice of the checkpoint's
global leaves (`distributed.checkpoint.load_train_state`).

``engine.state`` exposes the trainable parameters (the layer's own,
updated in place) and the optimizer state under the reference's names,
keyed by the parameters' structured names; a tied table appears once.
Frozen parameters (``requires_grad`` False) sit in ``state.buffers``.
Each parameter's update metadata (its regularizer, learning-rate
multiplier and name-based overrides: ``optimizer._leaf_meta``) and
whether clipping applies to it (``need_clip``) are read from the
parameter itself at construction. `memory_analysis` reports the device
memory of the first step at each batch signature and precision,
measured on the card as that step runs; `make_eval_step` is the
forward in eval mode without autograd.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import amp as _amp
from . import observe as _observe
from . import profiler as _profiler
from . import resolve_device
from .framework import faults as _faults
from .framework import flags as _flags
from .framework import monitor as _monitor
from .framework import random as _random
from .ops import lowp as _lowp

__all__ = ["Engine", "TrainState", "make_eval_step", "LOSS_SCALE_KEY",
           "GOOD_STEPS_KEY",
           "BAD_STEPS_KEY", "ANOMALY_BAD_STEPS_KEY", "GRAD_NORM_KEY",
           "LOWP_SCALE_KEY", "DEFAULT_SCALE_CONFIG"]

# reserved buffer names of the reference (paddle_tpu/engine.py:273-288)
LOSS_SCALE_KEY = "__loss_scale__"
GOOD_STEPS_KEY = "__loss_scale_good_steps__"
BAD_STEPS_KEY = "__loss_scale_bad_steps__"
ANOMALY_BAD_STEPS_KEY = "__anomaly_bad_steps__"
GRAD_NORM_KEY = "__grad_norm__"
LOWP_SCALE_KEY = "__lowp_scale__"
_RESERVED = (LOSS_SCALE_KEY, GOOD_STEPS_KEY, BAD_STEPS_KEY,
             ANOMALY_BAD_STEPS_KEY, GRAD_NORM_KEY, LOWP_SCALE_KEY)

# paddle GradScaler defaults (as the reference's DEFAULT_SCALE_CONFIG)
DEFAULT_SCALE_CONFIG = dict(
    init_loss_scaling=2.0 ** 15, incr_ratio=2.0, decr_ratio=0.5,
    incr_every_n_steps=1000, decr_every_n_nan_or_inf=2)


def _storage_bytes(tensors):
    """Bytes of the distinct CUDA storages behind `tensors`."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _precision_key(policy):
    """A hashable form of an `amp.policy()` (None when auto_cast is
    off)."""
    if policy is None:
        return None
    dtype, white, black, level = policy
    return dtype, frozenset(white), frozenset(black), level


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def make_eval_step(layer, mesh=None):
    """``eval_fn(values, *inputs)``: the layer's forward with its
    parameters and buffers taken from `values` (``{structured name:
    tensor}``; names left out keep the layer's own), in eval mode and
    without autograd; the layer's training flag is restored
    afterwards. `mesh` is taken and unused, as in the reference (each
    rank evaluates its own shards)."""
    def eval_fn(values, *inputs):
        was_training = layer.training
        layer.eval()
        try:
            with torch.no_grad():
                return torch.func.functional_call(layer, values, inputs)
        finally:
            if was_training:
                layer.train()

    return eval_fn


def _mesh_group(mesh):
    """The hybrid group behind `mesh`."""
    from .distributed.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise ValueError("Engine(mesh=...) needs the hybrid group of "
                         "fleet.init")
    if hcg.get_pipe_parallel_world_size() > 1:
        raise ValueError("pp > 1 trains through distributed.hybrid."
                         "make_gpt_hybrid_engine, not Engine")
    from .distributed.sharding import check_waiting_flags

    check_waiting_flags()
    return hcg


def mesh_comm_dtype(comm_dtype):
    """`comm_dtype`, or float16 when it is None and the fleet strategy
    turns fp16_allreduce on (the reference names the knob after that
    strategy)."""
    if comm_dtype is not None:
        return comm_dtype
    from .distributed.fleet import fleet

    strategy = fleet._user_defined_strategy
    if strategy is not None and strategy.fp16_allreduce:
        return "float16"
    return None


def heads_split(layer):
    """Whether `layer`'s attention heads are split over mp (a
    tensor-parallel packed projection)."""
    return any(getattr(p, "packed_heads", None) is not None and
               getattr(p, "split_axis", None) is not None
               for p in layer.parameters())


def dropout_layout(rng, hcg, rows, seq_len, split_heads):
    """The step's `DropoutLayout` on this rank: the step seed drawn from
    `rng`, its dp slice of `rows` rows, the sequence of `seq_len`
    positions and the mp coordinates."""
    return _random.DropoutLayout(
        rng.next_seed(),
        row0=hcg.get_data_parallel_rank() * rows, seq_len=seq_len,
        mp_rank=hcg.get_model_parallel_rank(),
        mp_degree=hcg.get_model_parallel_world_size(),
        heads_split=split_heads)


def step_buffers(bufs, loss_scale, anomaly_guard, device):
    """Put the step features' device scalars into `bufs` under the
    reference's reserved names: the dynamic scale and its good / bad
    step counters, the guard's counter, the recorded gradient norm
    (``FLAGS_record_grad_norm``, latched here, as in the reference).
    Returns (the scale config, whether the scale is dynamic, the static
    scale as a device scalar or None, whether the norm is recorded)."""
    cfg = dict(DEFAULT_SCALE_CONFIG)
    if isinstance(loss_scale, dict):
        cfg.update(loss_scale)
    dynamic = loss_scale == "dynamic" or isinstance(loss_scale, dict)
    f32, i32 = torch.float32, torch.int32
    static = None
    if dynamic:
        bufs[LOSS_SCALE_KEY] = torch.tensor(
            float(cfg["init_loss_scaling"]), dtype=f32, device=device)
        bufs[GOOD_STEPS_KEY] = torch.zeros((), dtype=i32, device=device)
        bufs[BAD_STEPS_KEY] = torch.zeros((), dtype=i32, device=device)
    elif loss_scale is not None:
        static = torch.tensor(float(loss_scale), dtype=f32, device=device)
    if anomaly_guard:
        bufs[ANOMALY_BAD_STEPS_KEY] = torch.zeros((), dtype=i32,
                                                  device=device)
    record_norm = _flags.flag("FLAGS_record_grad_norm")
    if record_norm:
        bufs[GRAD_NORM_KEY] = torch.zeros((), dtype=f32, device=device)
    return cfg, dynamic, static, record_norm


def update_loss_scale(bufs, cfg, finite):
    """The reference's in-graph GradScaler rule on the scale buffers:
    grow the scale after incr_every_n_steps consecutive finite steps,
    shrink it after decr_every_n_nan_or_inf consecutive non-finite
    ones."""
    scale = bufs[LOSS_SCALE_KEY]
    good, bad = bufs[GOOD_STEPS_KEY], bufs[BAD_STEPS_KEY]
    zero = torch.zeros_like(good)
    good_next = torch.where(finite, good + 1, zero)
    bad_next = torch.where(finite, zero, bad + 1)
    grow = finite & (good_next >= cfg["incr_every_n_steps"])
    shrink = ~finite & (bad_next >= cfg["decr_every_n_nan_or_inf"])
    bufs[LOSS_SCALE_KEY] = torch.where(
        grow, scale * cfg["incr_ratio"],
        torch.where(shrink, scale * cfg["decr_ratio"], scale))
    bufs[GOOD_STEPS_KEY] = torch.where(grow, zero, good_next)
    bufs[BAD_STEPS_KEY] = torch.where(shrink, zero, bad_next)


def _dp_sliced(batch_spec):
    """Whether `batch_spec` ("dp" or a spec whose first entry is "dp")
    shards the batch over dp; None replicates it."""
    spec = batch_spec[0] if isinstance(batch_spec, (tuple, list)) and \
        batch_spec else batch_spec
    if spec in (None, "dp"):
        return spec == "dp"
    raise NotImplementedError(
        f"batch_spec {batch_spec!r}: only the batch over 'dp' is ported")


class TrainState:
    def __init__(self, params, opt_state, buffers, step=0):
        self.params = params
        self.opt_state = opt_state
        self.buffers = buffers
        self.step = step


class Engine:
    """Drives the training of `layer` on `device` (default cuda; raises
    when no GPU is visible). One random source feeds every dropout of the
    step: an `RngState` on the device from `seed` (by default a draw
    from torch's default generator, which `paddle_tpu_torch.seed`
    seeds). Engines built with one seed on two devices drop the same
    attention elements."""

    def __init__(self, layer, optimizer, loss_fn, grad_clip=None,
                 device=None, seed=None, loss_scale=None,
                 anomaly_guard=False, comm_dtype=None, mesh=None,
                 batch_spec=None, zero_stage=0, sharding_axis=None,
                 offload=False):
        self.mesh = mesh
        self.hcg = None
        if mesh is not None:
            self.hcg = _mesh_group(mesh)
            comm_dtype = mesh_comm_dtype(comm_dtype)
            if device is None:
                from .distributed.parallel import device as _rank_device

                device = _rank_device()
        self.batch_spec = batch_spec
        self.zero_stage = zero_stage
        self.sharding_axis = sharding_axis
        self.offload = offload
        self.device = resolve_device(device)
        self.comm_dtype = comm_dtype
        self.layer = layer.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._grad_clip = grad_clip if grad_clip is not None else \
            optimizer._grad_clip
        # the trainable parameters only, as the reference's
        # `param_values`: a frozen one (requires_grad False, paddle's
        # stop_gradient) rides with the buffers, as in its
        # `buffer_values`, and gets no optimizer state, decay or update
        named = dict(layer.named_parameters())
        params = {k: p for k, p in named.items() if p.requires_grad}
        buffers = {k: p for k, p in named.items() if not p.requires_grad}
        buffers.update(layer.named_buffers())
        self._zero = None
        if self.hcg is not None:
            from .distributed.sharding import ZeroSharding

            stage = zero_stage if sharding_axis in ("sharding", "dp") \
                else 0
            self._zero = ZeroSharding(params, optimizer, self.hcg, stage,
                                      offload, axis=sharding_axis or
                                      "sharding")
            self._dp_slice = _dp_sliced(batch_spec)
            self._heads_split = heads_split(layer)
            opt_state = self._zero.states
        else:
            opt_state = {k: optimizer._init_state(p)
                         for k, p in params.items()}
        self.state = TrainState(params, opt_state, buffers)
        self._metas = {k: optimizer._leaf_meta(p) for k, p in params.items()}
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, ()))
        self.rng = _random.RngState(seed, self.device)
        self.loss_scale = loss_scale
        self.anomaly_guard = anomaly_guard
        bufs = self.state.buffers
        self._scale_cfg, self._dynamic, self._static_scale, \
            self._record_grad_norm = step_buffers(
                bufs, loss_scale, anomaly_guard, self.device)
        self._ckpt_manager = None
        self._batch_sigs = set()    # batch signatures stepped so far
        self._last_batch = None     # (inputs, labels, amp policy)
        self._mem = {}              # (signature, precision) -> analysis
        self._mem_key = None        # the last step's key into _mem
        if _lowp.mode() != "off":
            from .quantization.scaling import init_scale_state

            bufs[LOWP_SCALE_KEY] = init_scale_state(device=self.device)

    @property
    def anomaly_bad_steps(self):
        """Consecutive non-finite steps so far (an int32 device scalar;
        reading it as a number waits for the card)."""
        return self.state.buffers[ANOMALY_BAD_STEPS_KEY]

    def _tensor(self, x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def _rank_part(self, x):
        """This rank's dp slice of a global batch leaf (the leaf itself
        without a mesh or with a replicated batch)."""
        if self.hcg is None or not self._dp_slice:
            return x
        from .distributed.sharding import dp_slice

        return dp_slice(x, self.hcg)

    def train_batch(self, inputs, labels=()):
        """One step; returns the loss as a float32 0-dim device tensor
        (no host synchronisation, unless a guarded engine reads its
        counter this step)."""
        t_step0 = time.perf_counter()
        with _observe.phase("host-prep"):
            if not isinstance(inputs, (list, tuple)):
                inputs = (inputs,)
            if not isinstance(labels, (list, tuple)):
                labels = (labels,)
            # kept (host references, and the step's precision) so
            # attribute_step can replay the live step under a capture
            amp_policy = _amp.policy()
            self._last_batch = (inputs, labels, amp_policy)
            # a scheduled 'nan' fault poisons the float leaves of the
            # HOST batch: the deterministic way to exercise the guard
            batch = _faults.fault_point("train.batch",
                                        {"inputs": inputs, "labels": labels})
            sig = _observe.signature_of(batch)
            inputs = [self._tensor(self._rank_part(x))
                      for x in batch["inputs"]]
            labels = [self._tensor(self._rank_part(x))
                      for x in batch["labels"]]
        compiling = sig not in self._batch_sigs
        mem_key = (sig, _precision_key(amp_policy))
        measure = self.device.type == "cuda" and mem_key not in self._mem
        t_fn0 = time.perf_counter()
        with _observe.phase("compile" if compiling else "device-step"):
            if compiling:
                # may raise RetraceError (no_retrace): before any state
                # changes, so the engine steps on at its old shapes
                _observe.record_compile("train_step", signature=sig)
                self._batch_sigs.add(sig)
            if measure:
                other = self._start_peak([*inputs, *labels])
            loss = self._step(inputs, labels)
            if measure:
                self._mem[mem_key] = self._read_peak(other, inputs, labels,
                                                     loss)
        self._mem_key = mem_key
        if compiling:
            _observe.annotate("train_step",
                              wall_s=time.perf_counter() - t_fn0)
        self.state.step += 1
        if self.anomaly_guard:
            # the counter's host read blocks dispatch until the card
            # catches up, so it is amortised: the device skips every bad
            # update at once, the host only decides the ROLLBACK, up to
            # interval - 1 (bad, already skipped) steps late
            interval = _flags.flag("FLAGS_anomaly_check_interval")
            if interval <= 1 or self.state.step % interval == 0:
                with _observe.phase("anomaly-readback"):
                    self._check_anomaly()
        self._flight_record(loss, time.perf_counter() - t_step0)
        if _profiler.is_op_profiling_enabled():
            _profiler.record_device_memory("train_batch", self.device)
        return loss

    def _step(self, inputs, labels):
        """Forward, backward and update of one batch of device tensors;
        returns the detached float32 loss."""
        params = self.state.params
        bufs = self.state.buffers
        model_bufs = {k: b for k, b in bufs.items() if k not in _RESERVED}
        keep = None
        mesh_ctx = contextlib.nullcontext()
        if self._zero is not None:
            from .distributed.sharding import global_batch

            self._zero.gather_params()
            mesh_ctx = global_batch(self.hcg)
            x = inputs[0]
            self.rng.layout = dropout_layout(
                self.rng, self.hcg, x.shape[0] if self._dp_slice else 0,
                x.shape[1] if x.dim() >= 2 else None, self._heads_split)
        if self.anomaly_guard:
            # the forward may update buffers in place (running stats)
            old_bufs = {k: b.clone() for k, b in model_bufs.items()}
        for p in params.values():
            p.grad = None
        lowp_prev = bufs.get(LOWP_SCALE_KEY)
        lowp_next = None
        # comm_dtype: the step's forward and loss under O2 autocast of
        # that dtype over the f32 parameters (their gradients come back
        # in f32 through the casts), as the reference's step
        amp_ctx = _amp.auto_cast(enable=True, level="O2",
                                 dtype=self.comm_dtype) \
            if self.comm_dtype is not None else contextlib.nullcontext()
        try:
            with _random.rng_scope(self.rng), amp_ctx, \
                    _lowp.engine_scope(), mesh_ctx, \
                    _lowp.scale_region(lowp_prev) as lowp_rec:
                loss = self.loss_fn(self.layer(*inputs), *labels).float()
                if lowp_rec is not None:
                    lowp_next = lowp_rec.updated()
        finally:
            self.rng.layout = None
        scale = bufs[LOSS_SCALE_KEY] if self._dynamic else \
            self._static_scale
        (loss * scale if scale is not None else loss).backward()
        # a parameter the loss does not reach has a zero gradient, as in
        # the reference (its moments still decay)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        opt = self.optimizer
        if self._zero is not None:
            from .distributed.sharding import global_mean, meshed_update

            loss = global_mean(loss.detach(), self.hcg)
            finite, guard_ok, gnorm = meshed_update(
                self._zero, grads, opt._lr_scalar(self.device), self._metas,
                scale=scale, loss=loss if self.anomaly_guard else None,
                grad_clip=self._grad_clip, comm_dtype=self.comm_dtype,
                record_norm=self._record_grad_norm)
            self.state.opt_state = self._zero.states    # offload moves it
        else:
            # finiteness of the RAW unscaled gradients, before decay and
            # clipping (a value clipper would map inf to finite values)
            if scale is not None:
                grads = {k: g / scale for k, g in grads.items()}
                finite = keep = _amp.all_finite(list(grads.values()))
            if self.anomaly_guard:
                # the guard also counts the loss (a NaN loss with zero
                # grads); guard_ok implies finite, so it alone decides
                guard_ok = keep = (finite if scale is not None else
                                   _amp.all_finite(list(grads.values()))) \
                    & torch.isfinite(loss)
            if self._record_grad_norm:
                # the global l2 norm of the RAW grads (unscaled, before
                # decay and clipping): the number a clipper would see
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g in grads.values()))
            grads = opt.decay_gradients(params, grads, self._metas)
            if self._grad_clip is not None:
                grads = self._grad_clip._clip_fn(grads, params)
            # made by torch.full, which passes the value as a kernel
            # argument: a new rate (an LR scheduler's) never waits for
            # the card
            opt.apply_gradients(params, grads, self.state.opt_state,
                                opt._lr_scalar(self.device), self._metas,
                                keep)
        if self.anomaly_guard:
            with torch.no_grad():
                for k, b in model_bufs.items():
                    b.copy_(torch.where(guard_ok, b, old_bufs[k]))
            prev = bufs[ANOMALY_BAD_STEPS_KEY]
            bufs[ANOMALY_BAD_STEPS_KEY] = torch.where(
                guard_ok, torch.zeros_like(prev), prev + 1)
            if lowp_next is not None:
                # a bad step keeps the previous scales: its amaxes may be
                # the very poison being skipped
                lowp_next = type(lowp_next)(*(
                    torch.where(guard_ok, new, old)
                    for new, old in zip(lowp_next, lowp_prev)))
        if lowp_next is not None:
            bufs[LOWP_SCALE_KEY] = lowp_next
        if self._record_grad_norm:
            bufs[GRAD_NORM_KEY] = gnorm
        if self._dynamic:
            update_loss_scale(bufs, self._scale_cfg, finite)
        return loss.detach()

    def sync_to_layer(self):
        """Make the layer current with the engine's state. The engine
        trains the layer's own parameters in place, so there is nothing
        to copy, except under ZeRO-3, whose parameters rest as slices
        between steps: they are all-gathered into the layer."""
        if self._zero is not None:
            self._zero.gather_params()

    def _resident_bytes(self):
        st = self.state
        return _storage_bytes(_leaves([st.params, st.opt_state,
                                       st.buffers]))

    def _start_peak(self, batch):
        """Open a measurement of the next step's device memory: the
        bytes allocated that are neither the engine's state nor the
        step's batch on the card, then a reset of the peak. The
        allocator's counts move as ops are issued, so neither this nor
        `_read_peak` waits for the card."""
        other = (torch.cuda.memory_allocated(self.device)
                 - self._resident_bytes() - _storage_bytes(batch))
        torch.cuda.reset_peak_memory_stats(self.device)
        return other

    def _read_peak(self, other, inputs, labels, loss):
        resident = self._resident_bytes()
        peak = torch.cuda.max_memory_allocated(self.device) - other
        arguments = resident + sum(t.numel() * t.element_size()
                                   for t in (*inputs, *labels))
        return {"arguments": arguments, "temps": max(peak - arguments, 0),
                "outputs": resident + loss.numel() * loss.element_size(),
                "alias": resident, "generated_code": 0, "peak": peak,
                "host_arguments": 0, "host_temps": 0, "host_outputs": 0}

    def memory_analysis(self):
        """The device memory of one training step, in bytes, under the
        reference's keys, MEASURED on the card. The first real step of
        each batch signature and precision (auto_cast policy) is taken
        under ``torch.cuda.reset_peak_memory_stats`` /
        ``max_memory_allocated`` and its result kept; this returns the
        one of the last step's signature and precision, and itself runs
        no step, so it changes no state. ``arguments`` is the resident
        state (parameters, optimizer state, buffers) plus the batch on
        the card; ``peak`` the step's high-water mark above the
        allocations that are not the engine's; ``temps`` the
        activations and workspace above the arguments; ``outputs`` the
        state the step writes plus its loss, and ``alias`` the part of
        it written in place over the arguments (all of the state). No
        step program is compiled (``generated_code`` 0) and no state
        rests in host memory (the ``host_*`` three 0). Raises before the
        first step, and on an engine that does not run on a card."""
        if self._last_batch is None:
            raise RuntimeError("run train_batch() once first")
        if self.device.type != "cuda":
            raise RuntimeError(
                "memory_analysis measures the card's allocator "
                f"(torch.cuda); this engine runs on {self.device}")
        out = dict(self._mem[self._mem_key])
        _monitor.stat_max("device_mem_step_peak_bytes", out["peak"])
        _observe.annotate("train_step", peak_bytes=out["peak"])
        return out

    def attribute_step(self, logdir=None, steps=1, top=10):
        """Where does the device time of a training step go?  Captures a
        `profiler` trace of `steps` replays of the LAST train_batch
        (real steps: training advances by `steps`), synchronised with
        the engine's device before the capture stops, and classifies its
        device time into matmul / attention / collective / elementwise /
        other buckets (observe.attribute). Returns the report (buckets,
        fractions, total_us, top_ops); the capture stays under
        `logdir`. The replays run under the auto_cast policy of the step
        they replay."""
        logdir = self._capture(logdir, steps, "paddle-attrib-")
        return _observe.attribute(logdir, top=top)

    def overlap_report(self, logdir=None, steps=1):
        """Capture `steps` real steps as attribute_step does and pair the
        collective bucket against concurrently-resident matmul /
        attention time (observe.overlap_report's dict; one process on
        one card launches no collective, so its collective time is 0)."""
        logdir = self._capture(logdir, steps, "paddle-overlap-")
        return _observe.overlap_report(logdir)

    def _capture(self, logdir, steps, prefix):
        if self._last_batch is None:
            raise RuntimeError("run train_batch() once first")
        if logdir is None:
            import tempfile

            logdir = tempfile.mkdtemp(prefix=prefix)
        inputs, labels, amp_policy = self._last_batch
        _profiler.start_trace(logdir, device=self.device)
        try:
            with _amp.policy_scope(amp_policy):
                for _ in range(steps):
                    self.train_batch(inputs, labels)
            # every step's kernels land inside the capture window
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            _profiler.stop_trace()
        return logdir

    def _flight_record(self, loss, step_s):
        """One flight-recorder entry per step. The loss, the grad norm
        and the guard's counter stay device tensors (no host sync here);
        the recorder reads them only when a black box is dumped."""
        fields = {"loss": loss, "step_ms": step_s * 1e3}
        bufs = self.state.buffers
        if self._record_grad_norm:
            fields["grad_norm"] = bufs[GRAD_NORM_KEY]
        if self.anomaly_guard:
            fields["anomaly_bad_steps"] = bufs[ANOMALY_BAD_STEPS_KEY]
        if self.device.type == "cuda" and \
                _flags.flag("FLAGS_flight_record_memory"):
            fields["bytes_in_use"] = torch.cuda.memory_allocated(self.device)
        _observe.flight.record_step(self.state.step, **fields)

    def attach_checkpoint_manager(self, manager):
        """Give the anomaly guard a rollback target: when
        FLAGS_anomaly_max_bad_steps consecutive steps go non-finite, the
        engine restores the newest readable checkpoint from this
        `distributed.checkpoint.CheckpointManager`
        (`train_epoch_range` attaches its own manager), or the newest
        globally committed step of a `GangCheckpointManager`."""
        self._ckpt_manager = manager

    def _agreed_step(self, manager):
        """The newest step every rank of the world can read from its own
        manager (a collective; None when some rank has none)."""
        from .distributed.collective import ReduceOp, all_reduce

        steps = manager.readable_steps()
        t = torch.tensor([steps[-1] if steps else -1], dtype=torch.int64,
                         device=self.device)
        all_reduce(t, ReduceOp.MIN)
        step = int(t[0])
        return None if step < 0 else step

    def _check_anomaly(self):
        """Step-boundary policy of the guard: ONE host read of the
        consecutive-bad-step counter, then a rollback once the budget
        is spent (under a mesh every rank reads the same counter, so the
        rollback is a collective decision)."""
        bufs = self.state.buffers
        bad = int(bufs[ANOMALY_BAD_STEPS_KEY])
        if bad == 0:
            return
        _monitor.stat_add("anomaly_bad_steps")
        max_bad = _flags.flag("FLAGS_anomaly_max_bad_steps")
        if not max_bad or bad < max_bad:
            return  # skipped on the device; give the run a chance
        if self._ckpt_manager is None:
            from .framework.errors import PreconditionNotMetError

            raise PreconditionNotMetError(
                f"anomaly guard: {bad} consecutive non-finite steps and "
                "no checkpoint manager attached for rollback — call "
                "engine.attach_checkpoint_manager(...) or train via "
                "checkpoint.train_epoch_range")
        import warnings

        from .distributed import checkpoint as _ckpt

        # the rollback overwrites the live (anomalous) state: keep the
        # black box first so the post-mortem still has the bad steps
        _observe.flight.note("anomaly_rollback", bad_steps=bad,
                             engine_step=self.state.step)
        _observe.flight.dump("anomaly-rollback")
        mgr = self._ckpt_manager
        if isinstance(mgr, _ckpt.GangCheckpointManager):
            step = mgr.restore_engine(self)
        else:
            mgr.wait_until_finished()
            at = None
            if self.hcg is not None:
                at = self._agreed_step(mgr)
                if at is None:
                    raise FileNotFoundError(
                        "anomaly guard: no checkpoint step that every "
                        "rank can read")
            step, _ = mgr.restore_with(
                lambda p: _ckpt.load_train_state(p, self), step=at)
        # the restored snapshot predates the anomaly: the guard re-arms
        # from zero
        bufs = self.state.buffers
        bufs[ANOMALY_BAD_STEPS_KEY] = torch.zeros(
            (), dtype=torch.int32, device=self.device)
        _monitor.stat_add("anomaly_rollbacks")
        warnings.warn(
            f"anomaly guard: {bad} consecutive non-finite steps; rolled "
            f"back to checkpoint ckpt-{step} (engine step "
            f"{self.state.step})")
