"""Continuous-batching decode engine over a block-paged KV cache
(counterpart of paddle_tpu/serving/engine.py, single device).

- ONE physical block pool per layer, ``[num_blocks, nh, block_size,
  hd]`` in ``cache_dtype`` (f32 by default; a bf16 pool halves the
  bytes — the step casts on write and attends in f32, four more
  launches a layer, which a host-bound decode step feels: at
  gpt2-small on an H100, 1.08-1.15x the f32 pool's step), plus a
  per-slot block table ``[max_slots, blocks_per_slot]``. A request
  holds only the blocks its length needs.
- ONE step function over a fixed ``[max_slots, prefill_chunk]`` token
  matrix: decoding slots occupy one column, prefilling slots up to
  ``prefill_chunk`` prompt columns (chunked prefill); padding routes to
  the reserved null block. Only each slot's last valid row reaches the
  LM head.
- Prefix sharing through the radix `PrefixCache`, with copy-on-write
  when a request diverges inside a cached block.
- Admission by free blocks: a request needing more blocks than the
  whole pool sheds with the retriable 429 `CapacityExhaustedError`.

Int8 weights (``quantize`` / FLAGS_serving_quantize): 2-D weights are
frozen per tensor to int8 + ``@scale`` companions and stay int8 at rest
on the device; every step dequantizes them with the one canonical
formula (`ops.quant_ops.dequant_int8`) into f32 for the trunk's
matmuls, and the tied LM head runs the `dequant_matmul` kernel (B7)
against the int8 table. w8a8 (``w8a8`` / FLAGS_serving_w8a8) also
quantizes the head's activation rows through the `w8a8_matmul` kernel
(B8) against a per-tensor scale calibrated from warmup plus the first
`_W8A8_CALIB_STEPS` steps' abs-max, then frozen. The scale is a device
tensor updated with `torch.maximum` and read by the kernel through a
pointer, never synchronised to the host; which head runs is decided on
the host from the engine's own count of absorbed steps (the reference's
``lax.cond(act_scale > 0)``): warmup runs B7 and absorbs one abs-max,
so every real step of a w8a8 engine runs B8.

Speculative decoding (``spec_len`` / FLAGS_serving_spec_len = k > 0):
each decode round proposes up to k tokens per slot from a draft model
(self-draft when none is given; a quantized engine's draft runs on its
weights dequantized once at build, through ``model.logits``, not a
kernel) and verifies them IN the unified step — the slot stages
``[next, d_1..d_k]`` across the chunk columns it already owns, and the
step also projects the first k+1 columns' hidden rows ``[S, k+1, H]``
through the head (under ``quantize`` a second B7 / B8 call, on 8·(k+1)
rows), so the host runs Leviathan-style accept / residual-resample per
slot. A rejected suffix leaves garbage KV above the committed position,
which the next round's staging overwrites before any row can attend it.
The draft runs its own step over separate pools sharing THIS engine's
block tables; its cache trails the committed sequence (per-slot
``dfill``) and self-heals by catch-up, so a faulted draft phase simply
degrades the round to plain decode. Greedy speculative decode is token-
identical to plain greedy whenever the head gives each row the same
bits whatever the number of rows beside it: every emitted token is an
argmax of a verify row equal to the row the plain engine computes.

Batched LoRA banks (``max_adapters`` / ``lora_rank``): stacked
``[n, r, H]`` / ``[n, V, r]`` device tensors; each slot carries an
adapter id (row 0 = base model, all-zero) and the head's logits pick up
`lora_logits_delta` after the head (the w8a8 abs-max is taken before
it). `swap_adapters` replaces the banks at a step boundary.

The SSD KV spill tier (``spill_dir`` / FLAGS_serving_kv_spill_dir): the
process-shared `KVSpillStore` is the radix cache's spill hook — a cold
block evicted from the cache persists its KV rows to disk before the
allocator frees it, and a later request whose token prefix extends a
spilled record restores the blocks through `_maybe_restore`. A torn,
bit-rotted or fenced record degrades to re-prefill.

KV adoption and migration: `export_prefix_blocks` gathers a prompt's
cached blocks to the host and `adopt_prefix_blocks` writes them into
another engine's pool and prefix cache (serving/migrate.py).

Differences from the reference, by design: the KV pools are updated IN
PLACE (the reference returns new pools). Where the reference snapshots
its immutable pools, the port relies on which rows a step can write:
`_spill_block` copies the block's rows to the host before the hook
returns (the freeing decref follows it), and `export_prefix_blocks`
may gather from another thread while a step runs because the blocks it
gathers are pinned and cached, and no step writes a cached block — a
slot sharing one starts writing past it, and a divergence inside one
is copied first (copy-on-write). Its match and pinning take the host
lock the serve loop holds through each admission and step. Every step
runs `functional_call` on the engine's own module shell
(`module_shell`: the model's module tree sharing its parameter
tensors), because `functional_call` swaps the attributes of the
modules it runs: fleet replicas built on one model step from their
threads at once. Left for later slices: mesh sharding.

Compile counters and spans. PyTorch runs eagerly; what the engine
counts as a compile is the first call of each of its step functions
at a new (shape, dtype) signature — the unified step (``decode``,
recorded as ``serving.step`` in `observe.retrace`), the copy-on-write
copy (``cow``, ``serving.cow``) and, with ``spec_len`` > 0, the draft
step (``draft``, ``serving.draft``). The token matrix and tables never
change shape, so `compile_counts` stays at one each for the engine's
life. `warmup()` runs all of them and returns `compile_counts`; a
repeat warmup runs under `observe.no_retrace()`, and a
``strict_shapes=True`` engine serves its whole loop under it once
warmed. Each step runs in the reference's spans: the ``sample`` phase
(host-side picks and staging), ``draft`` (speculative rounds), the
``serving.step`` span around the ``device-step`` phase (the step's
launches; the logits' copy to the host follows it), and the
``serving.cow`` / ``serving.draft`` spans around each copy-on-write
copy and draft micro-step.

Fleet supervision: a ``supervised=True`` engine (a fleet replica) beats
a heartbeat (`heartbeats`, `last_beat`) each loop iteration and fires
``serving.replica_heartbeat`` there (a `raise` kills the engine thread:
the watchdog sees a crash) and ``serving.replica_step`` before each
decode step (a `raise` is a step error, a `delay` a hang), both tagged
with the engine's name. `abandon` is the supervisor's takeover of a
dead or hung replica. Requests may carry a ``tenant`` (billed per
tenant in the metrics) and a ``priority``.

Fault sites: ``serving.step`` fires once per decode step (a `raise`
fails every in-flight request while the engine stays up);
``serving.alloc_block`` on every physical block allocation (paging.py);
``serving.cow_split`` before every copy-on-write block copy;
``serving.draft`` before each speculative draft phase (raise = degrade
that round to plain decode, no lost or duplicated tokens);
``serving.verify`` before each speculative verify step (raise = step
error, fails in-flight requests); ``serving.dequant`` once per step of
an int8-frozen engine; ``serving.w8a8`` once per step of a w8a8 engine
(raise = that step runs the weights-only head); ``serving.kv_restore``
before each spilled-block restore (raise = restore abort, leak-free,
the request re-prefills); ``serving.kv_migrate`` before each adopted
block; ``serving.adapter_swap`` before an adapter-bank hot-swap
mutates anything (raise = the old bank keeps serving bitwise).

Logits come to the host once per step (``logits.cpu().numpy()``) and
sampling stays numpy ``RandomState`` per request, exactly as in the
reference, so sampled tokens agree too given equal logits.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time

import numpy as np
import torch
from torch.func import functional_call

from .. import observe, profiler, resolve_device
from ..framework import faults
from ..framework.flags import flag
from ..nlp.transformers.gpt import lora_logits_delta
from ..ops import lowp, quant_ops
from ..quantization import (
    SCALE_SUFFIX, dequantize_state, is_quantized_state, quantize_state_int8,
)
from . import kvstore
from .metrics import ServingMetrics
from .paging import NULL_BLOCK, BlockAllocator, PoolExhausted, PrefixCache
from .queueing import (
    AdmissionQueue, CapacityExhaustedError, DeadlineExceededError, Request,
    RequestCancelled,
)

__all__ = ["SlotEngine", "speculative_accept", "module_shell"]


def module_shell(model):
    """A structural copy of `model` sharing every parameter and buffer
    tensor (no weight is copied). `functional_call` swaps the
    attributes of the modules it runs, so each engine, and the
    rollout's golden chain, runs its own shell: engines built on one
    model step from their threads at once without seeing each other's
    weights."""
    memo = {id(t): t for t in itertools.chain(model.parameters(),
                                              model.buffers())}
    return copy.deepcopy(model, memo)


def speculative_accept(p_list, q_list, proposals, rng):
    """Leviathan-style rejection sampling over one drafted chain.

    `p_list[j]` / `q_list[j]` are the (identically warped) target and
    draft probability vectors at the position of `proposals[j]`. Accept
    d_j while ``u_j < min(1, p_j(d_j) / q_j(d_j))``; on first rejection
    resample from the residual ``normalize(max(p - q, 0))``. Returns
    ``(accepted_count, resampled_token_or_None)`` — None means every
    proposal survived (the caller then samples the bonus token from the
    verify step's final logits row). The emitted-token distribution
    equals sampling from p directly. Pure host-side numpy."""
    for j, d in enumerate(proposals):
        p, q = p_list[j], q_list[j]
        if rng.random_sample() < min(1.0, float(p[d]) / max(float(q[d]),
                                                            1e-20)):
            continue
        residual = np.maximum(p - q, 0.0)
        tot = residual.sum()
        if tot <= 0.0:
            # p == q exactly and still rejected (u landed on the
            # boundary): any residual draw is p-distributed; use p
            residual, tot = p, p.sum()
        return j, int(rng.choice(residual.size, p=residual / tot))
    return len(proposals), None


def _torch_dtype(dtype):
    """A pool dtype given as a `torch.dtype` or its name ('bfloat16',
    'torch.float32', ...); None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype).replace("torch.", ""), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown cache_dtype {dtype!r}")
    return found


def _to_pool(rows, pool, tag=None):
    """Host KV rows (numpy, a numpy bfloat16 type, or raw bfloat16 words
    when `tag` — a spill record's or a payload's ``"dtype"`` — says
    ``bfloat16``) as a tensor of `pool`'s dtype on its device."""
    a, own = kvstore.host_rows(rows)
    a = np.array(a)                        # a writable copy
    if own == kvstore.BF16 or (tag == kvstore.BF16 and a.dtype == np.uint16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=pool.device, dtype=pool.dtype)


class _Slot:
    """One in-flight request's decode state (host side)."""

    def __init__(self, req, ids, fill, blocks):
        self.req = req
        self.prompt = np.asarray(ids, np.int32)
        self.prompt_len = int(self.prompt.size)
        self.tokens = [int(t) for t in ids]  # full sequence so far
        self.fill = fill        # prompt positions already in the cache
        self.blocks = blocks    # physical block ids, table order
        self.state = "prefill" if fill < self.prompt_len else "decode"
        self.advance = 0        # positions this step will write
        self.produced = 0
        self.next_logits = None  # np [V] feeding the next pick
        self.rng = None
        if req.gen.get("do_sample"):
            self.rng = np.random.RandomState(req.gen.get("seed", 0))
        # speculative-decoding state (unused when spec_len == 0): the
        # draft cache holds draft KV for tokens[0:dfill]; `fed` logs
        # every token fed to it this round (committed catch-up AND
        # proposals) so dfill advances exactly as far as the commit
        # agreed with what was fed, whatever the round's outcome
        self.dfill = 0
        self.fed: list = []
        self.drafted: list = []   # this round's proposals d_1..d_s
        self.qdists: list = []    # warped draft dists per proposal
        self.spec_staged: list = []  # proposals actually staged
        # a residual-resampled token is appended at commit but its KV is
        # not yet written; the next consume must feed it, not re-pick
        self.unfed = False


class _StepNet(torch.nn.Module):
    """The model's trunk over the paged caches plus the gather of each
    slot's last valid row (and, for speculative verify, the first
    `ncols` columns' rows), run through `torch.func.functional_call`
    so that every step can swap in freshly dequantized weights.
    `project` also runs the model's own head on the gathered rows."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tok, posmat, nvalid, caches, project, ncols):
        h, _ = self.model.gpt(tok, posmat, caches=caches)
        last = h[torch.arange(h.shape[0], device=h.device), nvalid - 1]
        cols = h[:, :ncols] if ncols else None
        if not project:
            return last, None, cols, None
        return (last, self.model.logits(last), cols,
                self.model.logits(cols) if ncols else None)


class SlotEngine:
    """Continuous-batching greedy/sampling decode over a GPT model.

    `model` is a `GPTForPretraining` on `device` (default cuda; an
    engine asked for cuda without a visible GPU raises). Requests carry
    `max_new_tokens`, optional `eos_token_id`, sampling params and an
    `adapter_id`; results are the full [prompt + generated] int32 id
    array.
    """

    # warmup + this many real steps feed the running abs-max before the
    # activation scale freezes
    _W8A8_CALIB_STEPS = 8

    def __init__(self, model, *, max_slots=None, max_seq_len=None,
                 block_size=None, num_blocks=None, prefill_chunk=None,
                 prefix_cache=None, cache_dtype=None, metrics=None,
                 queue=None, name=None, supervised=False, values=None,
                 weight_version=0, draft_model=None, spec_len=None,
                 quantize=None, w8a8=None, spill_dir=None,
                 max_adapters=None, lora_rank=None, strict_shapes=False,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device} but the engine runs on "
                f"{self.device}; build both on one device")
        model.eval()
        self.model = model
        self.name = name or "engine"
        self._net = _StepNet(module_shell(model))
        self.supervised = supervised
        self.last_beat = time.monotonic()
        self.heartbeats = 0
        self._abort_error = None
        cfg = model.config
        self.max_slots = max_slots or flag("FLAGS_serving_max_batch")
        self.max_seq_len = min(max_seq_len or cfg.max_seq_len,
                               cfg.max_seq_len)
        self.block_size = block_size or flag("FLAGS_serving_kv_block_size")
        self.blocks_per_slot = -(-self.max_seq_len // self.block_size)
        if num_blocks is None:
            num_blocks = flag("FLAGS_serving_kv_blocks")
        if not num_blocks:   # auto: dense-equivalent worst case + null
            num_blocks = self.max_slots * self.blocks_per_slot + 1
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2, got {num_blocks}")
        self.num_blocks = num_blocks
        self.prefill_chunk = min(
            prefill_chunk or flag("FLAGS_serving_prefill_chunk"),
            self.max_seq_len)
        self.spec_len = flag("FLAGS_serving_spec_len") \
            if spec_len is None else int(spec_len)
        if self.spec_len:
            # verify needs k+1 chunk columns per slot
            self.prefill_chunk = max(self.prefill_chunk, self.spec_len + 1)
            self.prefill_chunk = min(self.prefill_chunk, self.max_seq_len)
            if self.spec_len + 1 > self.max_seq_len:
                raise ValueError(
                    f"spec_len {self.spec_len} needs {self.spec_len + 1} "
                    f"chunk columns but max_seq_len is {self.max_seq_len}")
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.queue = queue if queue is not None else AdmissionQueue(
            flag("FLAGS_serving_queue_cap"), metrics=self.metrics)
        if values is not None:
            self._values = {k: torch.as_tensor(v, device=self.device)
                            for k, v in values.items()}
        else:
            self._values = dict(model.state_dict())
        self.weight_version = int(weight_version)
        if quantize is None:
            quantize = flag("FLAGS_serving_quantize")
        if is_quantized_state(self._values):
            self.quantized = True   # pre-frozen artifact
        elif quantize:
            self._values = quantize_state_int8(self._values)
            self.quantized = True
        else:
            self.quantized = False
        # tied-embedding LM head on the dequant-matmul kernel: find the
        # int8 table + scale once; untied heads keep the model's own
        self._head_key = None
        if self.quantized:
            self.metrics.set_gauge("dequant_path", 1.0)
            for k in self._values:
                if k.endswith("word_embeddings.weight") and \
                        (k + SCALE_SUFFIX) in self._values and \
                        cfg.tie_word_embeddings:
                    self._head_key = (k, k + SCALE_SUFFIX)
                    break
        if w8a8 is None:
            w8a8 = flag("FLAGS_serving_w8a8")
        self.w8a8 = bool(w8a8) and self._head_key is not None
        self._act_scale = torch.zeros((), dtype=torch.float32,
                                      device=self.device)
        self._act_calib = 0
        self._act_frozen = False
        self._w8a8_degraded = False
        if self.w8a8:
            self.metrics.set_gauge("w8a8_path", 1.0)
        # batched LoRA adapters: stacked [n, r, H] / [n, V, r] banks on
        # the device; each slot gathers its own row by index (row 0 =
        # base model, all-zero)
        if max_adapters is None:
            max_adapters = flag("FLAGS_serving_max_adapters")
        self.max_adapters = int(max_adapters or 0)
        if lora_rank is None:
            lora_rank = flag("FLAGS_serving_lora_rank")
        self.lora_rank = int(lora_rank)
        self.adapter_version = 0
        self._lora_a = self._lora_b = None
        if self.max_adapters:
            if self.lora_rank < 1:
                raise ValueError(
                    f"lora_rank must be >= 1, got {self.lora_rank}")
            self._lora_a = torch.zeros(
                (self.max_adapters, self.lora_rank, cfg.hidden_size),
                device=self.device)
            self._lora_b = torch.zeros(
                (self.max_adapters, cfg.vocab_size, self.lora_rank),
                device=self.device)
            self.metrics.set_gauge("max_adapters", float(self.max_adapters))
        self.cache_dtype = _torch_dtype(cache_dtype)
        self._ks, self._vs = self._pools(cfg)
        self._alloc = BlockAllocator(self.num_blocks)
        if prefix_cache is None:
            prefix_cache = flag("FLAGS_serving_prefix_cache")
        self._cache = PrefixCache(self._alloc, self.block_size) \
            if prefix_cache else None
        # persistent KV spill tier: one shared store per spill
        # directory, so every engine of the process spills into — and
        # can resume from — the same tier. None = disabled.
        self.spill_store = kvstore.open_spill_store(
            spill_dir, metrics=self.metrics) \
            if self._cache is not None else None
        if self.spill_store is not None:
            self._cache.spill_hook = self._spill_block
        # per-engine prefix stats (the metrics registry may be shared)
        self.prefix_lookups = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0
        self._pos = np.zeros((self.max_slots,), np.int32)
        self._aid = np.zeros((self.max_slots,), np.int32)
        self._bt = np.full((self.max_slots, self.blocks_per_slot),
                           NULL_BLOCK, np.int32)
        self._slots: list = [None] * self.max_slots
        self._free = list(range(self.max_slots))
        self._warmed = False
        self._strict = strict_shapes
        # compile counters: step key -> first calls at a new signature
        self._compiles: dict = {}
        self._signatures: set = set()
        self._abort = threading.Event()
        self._thread = None
        # KV adoptions and adapter-bank swaps land at step boundaries:
        # callers enqueue here and the serve loop applies them
        self._migrate_q: list = []
        self._adapter_q: list = []
        self._migrate_lock = threading.Lock()
        # the host bookkeeping (allocator refcounts, radix cache, slot
        # tables): the serve loop holds it through each admission and
        # step, `export_prefix_blocks` from another thread only around
        # its own match / incref and decref
        self._host_lock = threading.Lock()
        if self.spec_len:
            self._build_draft(draft_model)

    def _pools(self, cfg):
        """Zeroed per-layer K and V pools of `cfg`'s geometry; their
        bytes are added to `kv_pool_bytes`."""
        hd = cfg.hidden_size // cfg.num_heads
        shape = (self.num_blocks, cfg.num_heads, self.block_size, hd)
        ks = [torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
              for _ in range(cfg.num_layers)]
        vs = [torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
              for _ in range(cfg.num_layers)]
        self.kv_pool_bytes = getattr(self, "kv_pool_bytes", 0) + int(
            2 * cfg.num_layers * np.prod(shape) * ks[0].element_size())
        return ks, vs

    def _build_draft(self, draft_model):
        """The speculative draft: its model (self-draft when None), its
        float weights (a quantized engine's dequantized once, here) and
        its own pools sharing this engine's block tables."""
        cfg = self.model.config
        self.draft_model = draft_model if draft_model is not None \
            else self.model
        self.draft_model.eval()
        dcfg = self.draft_model.config
        if self.draft_model.device != self.device:
            raise ValueError(
                f"draft model lives on {self.draft_model.device}, the "
                f"engine on {self.device}")
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}")
        if dcfg.max_seq_len < self.max_seq_len:
            raise ValueError(
                f"draft max_seq_len {dcfg.max_seq_len} < engine "
                f"max_seq_len {self.max_seq_len}")
        self._dvalues = dict(self.draft_model.state_dict()) \
            if draft_model is not None else dict(self._values)
        if is_quantized_state(self._dvalues):
            self._dvalues = dequantize_state(self._dvalues)
        self._dnet = _StepNet(module_shell(self.draft_model))
        self._dks, self._dvs = self._pools(dcfg)
        self._draft_chunk = self.spec_len + 1

    # -- introspection ------------------------------------------------------

    @property
    def active(self):
        return sum(1 for s in self._slots if s is not None)

    @property
    def free_blocks(self):
        """Currently unreferenced physical blocks."""
        return self._alloc.free_blocks

    @property
    def blocks_in_use(self):
        return self._alloc.blocks_in_use

    @property
    def prefix_cache_size(self):
        return len(self._cache) if self._cache is not None else 0

    def _blocks_needed(self, n_positions):
        return -(-int(n_positions) // self.block_size)

    # -- the device step ----------------------------------------------------

    def _head(self, rows, quant):
        """Project hidden rows (.., H) to f32 logits (.., V) against the
        frozen int8 tied table: B8 (w8a8) when `quant`, else B7."""
        qk, sk = self._head_key
        q, s = self._values[qk], self._values[sk]
        if quant:
            # the [V, H] table's transpose, read in place by the kernel
            return lowp.w8a8_matmul(rows, q.t(), s, self._act_scale)
        return quant_ops.dequant_matmul(rows, q, s)

    def _arg(self, a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _run(self, net, values, ks, vs, tok, pos, nvalid, project, ncols):
        """One paged forward of `net` over the [S, C] token matrix:
        scatter the chunk's KV into `ks` / `vs` (in place), return the
        last valid rows, the verify columns and, with `project`, their
        logits through the model's own head."""
        tok_t, pos_t, nv_t = self._arg(tok), self._arg(pos), \
            self._arg(nvalid)
        bt_t = self._arg(self._bt)
        # clamp padding rows' position ids into the embedding table;
        # their KV writes route to the null block regardless
        posmat = torch.clamp(
            pos_t[:, None] + torch.arange(tok_t.shape[1], device=self.device),
            max=self.max_seq_len - 1)
        caches = [(k, v, (pos_t, bt_t)) for k, v in zip(ks, vs)]
        return functional_call(
            net, {"model." + k: v for k, v in values.items()},
            (tok_t, posmat, nv_t, caches, project, ncols))

    def _note_call(self, key, name, *arrays):
        """Count the first call of step function `key` at a new shape /
        dtype signature of its `arrays` as one compile (`compile_counts`,
        and `name` in observe.retrace — which raises inside no_retrace()
        before the step runs). The copy-on-write copy takes two block
        ids, the reference's ``(block, block)``."""
        seen = (key,) + tuple((a.shape, a.dtype.str) for a in arrays)
        if seen in self._signatures:
            return
        observe.record_compile(
            name, signature=observe.signature_of(*arrays) if arrays
            else "(block, block)")
        self._signatures.add(seen)
        self._compiles[key] = self._compiles.get(key, 0) + 1

    @property
    def compile_counts(self):
        """'decode' -> compiles of the unified prefill+decode step,
        'cow' -> of the copy-on-write block copy, 'draft' -> of the
        speculative draft micro-step (present only when spec_len > 0).
        The engine's invariant is every value == 1: the step's shapes
        are fixed for the engine's life."""
        return dict(self._compiles)

    def _device_step(self, tok, pos, nvalid):
        """One step over the whole pool: scatter the chunk's KV into the
        paged pools (in place), return the f32 logits of each slot's
        last valid row [S, V], of the first k+1 columns [S, k+1, V]
        under speculation (else None) and, for w8a8, the last rows'
        abs-max."""
        self._note_call("decode", "serving.step", tok, pos, self._bt)
        with torch.no_grad():
            fvals = dequantize_state(self._values) if self.quantized \
                else self._values
            project = self._head_key is None
            ncols = self.spec_len + 1 if self.spec_len else 0
            last, lv, cols, sv = self._run(
                self._net, fvals, self._ks, self._vs, tok, pos, nvalid,
                project, ncols)
            if not project:
                quant = self.w8a8 and self._act_calib > 0 \
                    and not self._w8a8_degraded
                lv = self._head(last, quant)
                if ncols:
                    sv = self._head(cols, quant)
            # w8a8 calibration: taken BEFORE any adapter delta — the
            # scale calibrates the shared trunk, not one adapter
            amax = last.float().abs().max() if self.w8a8 else None
            if self.max_adapters:
                aid = self._arg(self._aid)
                lv = lv + lora_logits_delta(last, aid, self._lora_a,
                                            self._lora_b)
                if ncols:
                    sv = sv + lora_logits_delta(cols, aid, self._lora_a,
                                                self._lora_b)
        return lv.float(), (sv.float() if ncols else None), amax

    def _draft_step(self, tok, pos, nvalid):
        """One draft step over the draft pools (in place): the f32
        logits of each slot's last valid row through the draft model's
        own head."""
        self._note_call("draft", "serving.draft", tok, pos, self._bt)
        with torch.no_grad():
            _, lv, _, _ = self._run(self._dnet, self._dvalues, self._dks,
                                    self._dvs, tok, pos, nvalid, True, 0)
        return lv.float()

    def _absorb_act_amax(self, amax):
        """Fold one step's head-input abs-max into the activation scale
        (device ops only — no host sync)."""
        if self._act_frozen or self._w8a8_degraded:
            return
        self._act_scale = torch.maximum(self._act_scale, amax)
        self._act_calib += 1
        if self._act_calib > self._W8A8_CALIB_STEPS:
            self._act_frozen = True

    def _cow(self, src, dst):
        """Copy-on-write: physical block `src` -> `dst` in every target
        pool (the draft cache re-feeds a new slot from position 0)."""
        self._note_call("cow", "serving.cow")
        for pool in self._ks + self._vs:
            pool[dst].copy_(pool[src])

    # -- batched adapter bank -----------------------------------------------

    def swap_adapters(self, lora_a, lora_b, version=None, timeout=5.0):
        """Hot-swap the stacked adapter bank. Applied at a step boundary
        when the serve loop is running, inline otherwise. All-or-
        nothing: a fault (``serving.adapter_swap``) or validation error
        leaves the OLD bank serving bitwise. Returns the new
        adapter_version."""
        if not self.max_adapters:
            raise ValueError(
                "engine built without adapters (max_adapters=0 / "
                "FLAGS_serving_max_adapters)")
        if self._thread is not None and self._thread.is_alive():
            done = threading.Event()
            box: dict = {}
            with self._migrate_lock:
                self._adapter_q.append((lora_a, lora_b, version, done,
                                        box))
            if not done.wait(timeout):
                raise TimeoutError(
                    f"engine {self.name!r} did not reach a step boundary "
                    f"within {timeout:.3f}s to swap adapters")
            if "error" in box:
                raise box["error"]
            return box["version"]
        return self._apply_adapter_swap(lora_a, lora_b, version)

    def _drain_adapter_swaps(self):
        while True:
            with self._migrate_lock:
                if not self._adapter_q:
                    return
                la, lb, version, done, box = self._adapter_q.pop(0)
            try:
                box["version"] = self._apply_adapter_swap(la, lb, version)
            except Exception as e:  # noqa: BLE001 — caller re-raises
                box["error"] = e
            finally:
                done.set()

    def _apply_adapter_swap(self, lora_a, lora_b, version):
        # the fault fires BEFORE any mutation: a faulted swap leaves
        # the old adapter bank serving bitwise
        faults.fault_point("serving.adapter_swap", tag=self.name)
        la = torch.as_tensor(lora_a, dtype=torch.float32).to(self.device)
        lb = torch.as_tensor(lora_b, dtype=torch.float32).to(self.device)
        if la.shape != self._lora_a.shape or \
                lb.shape != self._lora_b.shape:
            raise ValueError(
                f"adapter bank shapes {tuple(la.shape)}/{tuple(lb.shape)} "
                f"!= engine {tuple(self._lora_a.shape)}/"
                f"{tuple(self._lora_b.shape)}: rebuild the engine to "
                "change adapter capacity or rank")
        if bool(la[0].any()) or bool(lb[0].any()):
            raise ValueError(
                "adapter row 0 is the base model and must stay all-zero")
        self._lora_a, self._lora_b = la, lb
        self.adapter_version = int(version) if version is not None \
            else self.adapter_version + 1
        self.metrics.inc("adapter_swaps")
        return self.adapter_version

    # -- warmup -------------------------------------------------------------

    def warmup(self):
        """Run one dummy step, one copy-on-write copy (null block onto
        itself) and one draft step before traffic: every table points at
        the null block, so their writes land in reserved scratch. Builds
        the head kernel on first use and, for w8a8, absorbs the first
        activation abs-max. Returns `compile_counts`. A repeat warmup
        (re-entering the serve path) runs under `observe.no_retrace()`:
        the same shapes compile nothing new for the engine's life."""
        import contextlib

        guard = observe.no_retrace() if self._warmed \
            else contextlib.nullcontext()
        with guard:
            tok = np.zeros((self.max_slots, self.prefill_chunk), np.int32)
            pos = np.zeros((self.max_slots,), np.int32)
            nvalid = np.ones((self.max_slots,), np.int32)
            _, _, amax = self._device_step(tok, pos, nvalid)
            if self.w8a8:
                self._absorb_act_amax(amax)
            self._cow(NULL_BLOCK, NULL_BLOCK)
            if self.spec_len:
                self._draft_step(
                    np.zeros((self.max_slots, self._draft_chunk), np.int32),
                    pos, nvalid)
        self._warmed = True
        return self.compile_counts

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt_ids, *, max_new_tokens=16, eos_token_id=None,
               timeout=None, priority=0, do_sample=False, temperature=1.0,
               top_k=0, seed=0, adapter_id=0, tenant=None):
        """Admit one request (or shed); returns its `Request` future.

        Length beyond the model's positional range is a hard
        `ValueError`; a request whose block demand exceeds the whole
        physical pool sheds with the retriable `CapacityExhaustedError`."""
        if timeout is None:
            timeout = flag("FLAGS_serving_default_timeout_s") or None
        adapter_id = int(adapter_id or 0)
        if adapter_id < 0 or adapter_id >= max(self.max_adapters, 1):
            raise ValueError(
                f"adapter_id {adapter_id} outside the engine's bank "
                f"(max_adapters={self.max_adapters}; 0 = base model)")
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if ids.size + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_seq_len {self.max_seq_len}")
        need = self._blocks_needed(ids.size + max_new_tokens)
        if need > self._alloc.usable:
            self.metrics.inc("rejected_capacity")
            raise CapacityExhaustedError(
                f"request needs {need} KV blocks but the pool holds "
                f"{self._alloc.usable} (block_size={self.block_size})")
        return self.queue.submit(Request(
            ids, timeout=timeout, priority=priority,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            seed=seed, adapter_id=adapter_id, tenant=tenant))

    def _stage_blocks(self, ids, need_total):
        """Reserve the physical blocks for one admission: reuse every
        prefix-cached block, allocate the rest, copy-on-write when the
        divergence falls inside a cached block. Returns ``(blocks,
        fill)`` or raises (`PoolExhausted` = wait and retry). All-or-
        nothing: partial reservations are rolled back."""
        shared, n_shared, cow = [], 0, None
        if self._cache is not None:
            if self.spill_store is not None:
                # session resume: pull spilled records extending the
                # live cached prefix back into the pool first, so the
                # match below sees them as ordinary cache hits
                self._maybe_restore(ids)
            # always leave >= 1 prompt token to compute: the last
            # token's logits seed decode
            shared, n_shared, cow = self._cache.match(ids, ids.size - 1)
            self.metrics.inc("prefix_lookups")
            self.metrics.inc("prompt_tokens", int(ids.size))
            hit_tokens = n_shared + (cow[1] if cow else 0)
            if shared:
                self.metrics.inc("prefix_hit_blocks", len(shared))
            if hit_tokens:
                self.metrics.inc("prefix_hit_tokens", hit_tokens)
            self.prefix_lookups += 1
            self.prefix_prompt_tokens += int(ids.size)
            self.prefix_hit_tokens += hit_tokens
        n_new = need_total - len(shared)
        taken, new, pinned_src = [], [], None
        try:
            # pin every matched block (and the CoW source) BEFORE any
            # reclaim, so eviction under pressure never frees them
            for bid in shared:
                self._alloc.incref(bid)
                taken.append(bid)
            if cow is not None:
                self._alloc.incref(cow[0])
                pinned_src = cow[0]
            if self._alloc.free_blocks < n_new and self._cache is not None:
                self._cache.reclaim(n_new - self._alloc.free_blocks)
            if self._alloc.free_blocks < n_new:
                raise PoolExhausted(
                    f"need {n_new} free KV blocks, have "
                    f"{self._alloc.free_blocks}")
            for _ in range(n_new):
                new.append(self._alloc.alloc())
            fill = n_shared
            if cow is not None:
                src, rows = cow
                faults.fault_point("serving.cow_split")
                with profiler.RecordEvent("serving.cow", cat="serving"):
                    self._cow(src, new[0])
                self.metrics.inc("cow_splits")
                fill += rows
        except Exception:
            for bid in taken + new:
                self._alloc.decref(bid)
            if pinned_src is not None:
                self._alloc.decref(pinned_src)
            raise
        if pinned_src is not None:
            self._alloc.decref(pinned_src)
        return taken + new, fill

    def _admit(self):
        """Join-at-step: fill free slots from the queue while block
        capacity lasts. A request the pool cannot hold right now goes
        back to the queue head until an eviction frees blocks."""
        while self._free:
            req = self.queue.pop(timeout=0.0)
            if req is None:
                return
            ids = req.payload
            need = self._blocks_needed(
                ids.size + req.gen.get("max_new_tokens", 16))
            try:
                blocks, fill = self._stage_blocks(ids, need)
            except PoolExhausted:
                self.queue.requeue(req)
                return
            except Exception as e:  # noqa: BLE001 — fail req, stay up
                self.metrics.inc("failed")
                req._fail(e)
                continue
            slot = self._free.pop()
            self._bt[slot, :] = NULL_BLOCK
            self._bt[slot, :len(blocks)] = blocks
            self._pos[slot] = fill
            self._aid[slot] = int(req.gen.get("adapter_id", 0) or 0)
            self._slots[slot] = _Slot(req, ids, fill, blocks)
            self.metrics.inc("admitted")
            self.metrics.observe_latency(
                "queue", time.monotonic() - req.arrival)

    # -- KV adoption / migration --------------------------------------------

    def export_prefix_blocks(self, prompt_ids):
        """Gather this engine's fully written cached KV blocks covering
        `prompt_ids` to host arrays for migration. Returns a payload
        dict (tokens / per-layer (k_rows, v_rows) / geometry / dtype) or
        None when nothing is cached. Safe from another thread while the
        serve loop runs: the match and the pinning (incref) take the
        engine's host lock, so they fall between steps; the gather then
        runs beside the steps without it, because pinned blocks are not
        reclaimed and no step writes a cached block (a slot sharing one
        writes only past it; a divergence inside one is copied first).
        bf16 rows travel as their raw 16-bit words,
        ``payload["dtype"] == "bfloat16"``."""
        if self._cache is None:
            return None
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size < 2:
            return None
        with self._host_lock:
            shared, n_shared, _cow = self._cache.match(ids, ids.size - 1)
            for bid in shared:
                self._alloc.incref(bid)
        if not shared:
            return None
        try:
            idx = torch.as_tensor(shared, dtype=torch.long,
                                  device=self.device)
            host = [(kvstore.host_rows(k[idx]), kvstore.host_rows(v[idx]))
                    for k, v in zip(self._ks, self._vs)]
            layers = [(kr, vr) for (kr, _), (vr, _) in host]
            tag = host[0][0][1]
        finally:
            with self._host_lock:
                for bid in shared:
                    self._alloc.decref(bid)
        return {
            "tokens": [int(t) for t in ids[:n_shared]],
            "n_tokens": int(n_shared),
            "block_size": self.block_size,
            "layers": layers,
            "dtype": tag,
        }

    def adopt_prefix_blocks(self, payload, timeout=5.0):
        """Adopt migrated KV blocks into this engine's pool + prefix
        cache. Applied at a step boundary when the serve loop is
        running, inline otherwise. Returns the number of prompt tokens
        now served from cache (0 = incompatible payload). All-or-
        nothing: any fault mid-adoption frees every block taken so far
        — the pool is leak-free and the request prefills from
        scratch."""
        if self._thread is not None and self._thread.is_alive():
            done = threading.Event()
            box: dict = {}
            with self._migrate_lock:
                self._migrate_q.append((payload, done, box))
            if not done.wait(timeout):
                raise TimeoutError(
                    f"engine {self.name!r} did not reach a step boundary "
                    f"within {timeout:.3f}s to adopt migrated KV")
            if "error" in box:
                raise box["error"]
            return box["adopted"]
        return self._apply_adoption(payload)

    def _drain_adoptions(self):
        while True:
            with self._migrate_lock:
                if not self._migrate_q:
                    return
                payload, done, box = self._migrate_q.pop(0)
            try:
                box["adopted"] = self._apply_adoption(payload)
            except Exception as e:  # noqa: BLE001 — caller re-raises
                box["error"] = e
            finally:
                done.set()

    def _apply_adoption(self, payload):
        if self._cache is None or payload is None:
            return 0
        if payload.get("block_size") != self.block_size:
            return 0
        layers = payload["layers"]
        if len(layers) != len(self._ks):
            return 0
        nb = int(layers[0][0].shape[0]) if layers else 0
        if nb == 0 or tuple(layers[0][0].shape[1:]) != \
                tuple(self._ks[0].shape[1:]):
            return 0
        if self._alloc.free_blocks < nb:
            self._cache.reclaim(nb - self._alloc.free_blocks)
        tag = payload.get("dtype")
        taken: list = []
        try:
            for _ in range(nb):
                faults.fault_point("serving.kv_migrate", tag=self.name)
                taken.append(self._alloc.alloc())
            idx = torch.as_tensor(taken, dtype=torch.long,
                                  device=self.device)
            for li, (krows, vrows) in enumerate(layers):
                self._ks[li][idx] = _to_pool(krows, self._ks[li], tag)
                self._vs[li][idx] = _to_pool(vrows, self._vs[li], tag)
            n_tokens = nb * self.block_size
            self._cache.insert(payload["tokens"][:n_tokens], taken,
                               n_tokens)
        except Exception:
            for bid in taken:
                self._alloc.decref(bid)
            raise
        # the cache increfed every NEW entry; dropping our allocation
        # refs hands ownership over (and frees duplicate-key blocks the
        # cache already held under another id)
        for bid in taken:
            self._alloc.decref(bid)
        return nb * self.block_size

    # -- persistent KV spill tier -------------------------------------------

    def _spill_block(self, key, tokens, bid, n_rows):
        """PrefixCache donation hook: persist one evicted block's KV
        rows to the SSD tier BEFORE the freeing decref. The rows are
        copied to the host here (the pools are written in place, and
        the block is reused as soon as the hook returns). Best-effort —
        a spill fault loses durability for this block, never the
        eviction or the allocator balance."""
        if n_rows != self.block_size:
            return
        try:
            # a synchronous copy: the bytes are on the host when it
            # returns
            layers = [(k[bid].cpu(), v[bid].cpu())
                      for k, v in zip(self._ks, self._vs)]
            self.spill_store.append(key, self.weight_version, tokens,
                                    layers)
        except Exception:  # noqa: BLE001 — durability is best-effort
            self.metrics.inc("kv_spill_errors")

    def _maybe_restore(self, ids):
        """Resume staging: walk the prompt's cumulative-prefix digest
        chain past the live cached prefix and re-stage every matching
        spilled record through the all-or-nothing admission path
        (alloc → scatter → cache.insert, as KV adoption). Fault site
        ``serving.kv_restore`` fires per block; any failure — fault,
        fenced generation, torn or bit-rotted record, geometry/token
        mismatch, pool pressure — stops the walk leak-free and the
        request re-prefills the rest. Returns the number of tokens
        restored."""
        store, cache = self.spill_store, self._cache
        ids = np.asarray(ids, np.int32).reshape(-1)
        if store is None or cache is None or ids.size < 2:
            return 0
        t0 = time.monotonic()
        bs = self.block_size
        limit = ids.size - 1
        chain, n, _cow = cache.match(ids, limit)
        chain = list(chain)
        # gather every restorable record past the live chain first, then
        # stage them with ONE scatter per layer pool
        recs = []
        while n + len(recs) * bs + bs <= limit:
            m = n + len(recs) * bs
            key = cache._digest(ids[:m + bs])
            if key in cache._blocks:
                if recs:
                    break   # restored gap already ends at a live entry
                chain.append(cache._blocks[key])
                n += bs
                continue
            try:
                rec = store.get(key)
            except kvstore.SpillFencedError:
                self.metrics.inc("kv_restore_fenced")
                break
            if rec is None:
                break
            if (rec["generation"] != self.weight_version
                    or rec["block_size"] != bs
                    or len(rec["layers"]) != len(self._ks)
                    or tuple(rec["layers"][0][0].shape)
                    != tuple(self._ks[0].shape[1:])
                    or not np.array_equal(rec["tokens"], ids[:m + bs])):
                break
            recs.append(rec)
        if self._alloc.free_blocks < len(recs):
            # no reclaim here: it could evict our own chain
            recs = recs[:max(self._alloc.free_blocks, 0)]
        if not recs:
            return 0
        bids, inserted = [], 0
        try:
            for _ in recs:
                faults.fault_point("serving.kv_restore", tag=self.name)
                bids.append(self._alloc.alloc())
            idx = torch.as_tensor(bids, dtype=torch.long, device=self.device)
            for li in range(len(self._ks)):
                krows = np.stack([r["layers"][li][0] for r in recs])
                vrows = np.stack([r["layers"][li][1] for r in recs])
                tag = recs[0]["dtype"]
                self._ks[li][idx] = _to_pool(krows, self._ks[li], tag)
                self._vs[li][idx] = _to_pool(vrows, self._vs[li], tag)
            for bid in bids:
                chain.append(bid)
                cache.insert(ids[:n + bs], chain, n + bs)
                # the cache now owns its own ref; drop ours
                self._alloc.decref(bid)
                self.metrics.inc("kv_restored_blocks")
                n += bs
                inserted += 1
        except Exception:  # noqa: BLE001 — leak-free abort
            for bid in bids[inserted:]:
                if chain and chain[-1] == bid:
                    chain.pop()
                self._alloc.decref(bid)
        if inserted:
            self.metrics.observe_latency("kv_restore",
                                         time.monotonic() - t0)
        return inserted * bs

    def spill_cache(self):
        """Drain the radix cache through the spill tier: every
        evictable entry takes the normal eviction path, so blocks whose
        last reference is the cache's persist to SSD before they free.
        Call it while the engine is idle. Returns #entries dropped."""
        if self._cache is None:
            return 0
        n = len(self._cache)
        self._cache.clear()
        return n

    def prefix_hit_rate(self):
        """This engine's own prompt-token prefix hit rate."""
        return self.prefix_hit_tokens / self.prefix_prompt_tokens \
            if self.prefix_prompt_tokens else 0.0

    # -- sampling -----------------------------------------------------------

    @staticmethod
    def _warp_probs(logits, gen):
        """Temperature + top-k warped softmax, exactly the transform
        `_pick` samples from — speculative accept/reject compares
        target and draft through the SAME warp."""
        scaled = logits / max(gen.get("temperature", 1.0), 1e-6)
        top_k = gen.get("top_k", 0)
        if top_k:
            kth = np.sort(scaled)[-min(top_k, scaled.size)]
            scaled = np.where(scaled < kth, -np.inf, scaled)
        z = scaled - scaled.max()
        p = np.exp(z)
        p /= p.sum()
        return p

    def _pick(self, slot: _Slot):
        """Next token from the slot's pending logits (host-side so each
        request carries its own sampling config)."""
        logits = slot.next_logits
        gen = slot.req.gen
        if not gen.get("do_sample"):
            return int(logits.argmax())
        p = self._warp_probs(logits, gen)
        return int(slot.rng.choice(p.size, p=p))

    def _evict(self, idx, error=None):
        slot = self._slots[idx]
        self._slots[idx] = None
        self._free.append(idx)
        written = int(self._pos[idx])
        if error is None and self._cache is not None:
            # donate fully written blocks to the prefix index before
            # releasing our references — shared system prompts survive
            self._cache.insert(slot.tokens, slot.blocks, written)
        for bid in slot.blocks:
            self._alloc.decref(bid)
        self._bt[idx, :] = NULL_BLOCK
        self._pos[idx] = 0
        self._aid[idx] = 0
        tenant = slot.req.gen.get("tenant")
        if error is not None:
            self.metrics.inc("failed")
            if tenant:
                self.metrics.tenant_inc(tenant, "failed")
            slot.req._fail(error)
        else:
            self.metrics.inc("completed")
            self.metrics.observe_latency(
                "e2e", time.monotonic() - slot.req.arrival)
            if tenant:
                self.metrics.tenant_inc(tenant, "completed")
                self.metrics.tenant_inc(tenant, "tokens_out",
                                        slot.produced)
                self.metrics.tenant_observe_latency(
                    tenant, time.monotonic() - slot.req.arrival)
            slot.req._complete(np.asarray(slot.tokens, np.int32))

    def _fail_all_active(self, error):
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._evict(i, error)

    # -- the step -----------------------------------------------------------

    def _step(self):
        if self.quantized:
            # raise here propagates to _loop like any step error
            faults.fault_point("serving.dequant")
        self._w8a8_degraded = False
        if self.w8a8:
            # a fault here degrades THIS step to the weights-only head —
            # leak-free: no eviction, the step still commits its tokens
            try:
                faults.fault_point("serving.w8a8")
            except Exception:  # noqa: BLE001 — deterministic degrade
                self._w8a8_degraded = True
                self.metrics.inc("w8a8_degraded_steps")
        if self.spec_len:
            return self._step_spec()
        return self._step_plain()

    def _step_plain(self):
        """One continuous-batching iteration: consume each decoding
        slot's pending logits (finishing slots that hit
        EOS/max/deadline), stage the next chunk for prefilling slots,
        then ONE batched step over the whole pool."""
        try:
            faults.fault_point("serving.step")
        except Exception as e:  # noqa: BLE001 — deterministic mid-decode
            self._fail_all_active(e)
            return
        now = time.monotonic()
        tok = np.zeros((self.max_slots, self.prefill_chunk), np.int32)
        nvalid = np.ones((self.max_slots,), np.int32)
        live: list = []
        with observe.phase("sample", cat="serving"):
            prefill_tokens = self._consume_slots(now, tok, nvalid, live)
        if not live:
            return
        n_pref = sum(1 for i in live
                     if self._slots[i].state == "prefill")
        t0 = time.monotonic()
        with profiler.RecordEvent("serving.step", cat="serving"):
            with observe.phase("device-step", cat="serving"):
                logits, _, amax = self._device_step(tok, self._pos, nvalid)
                if self.w8a8:
                    self._absorb_act_amax(amax)
        logits = logits.cpu().numpy()
        self._observe_step_latency(time.monotonic() - t0,
                                   prefill_tokens, len(live) - n_pref)
        for i in live:
            slot = self._slots[i]
            self._pos[i] += slot.advance
            if slot.state == "prefill":
                slot.fill += slot.advance
                if slot.fill >= slot.prompt_len:
                    slot.state = "decode"
                    slot.next_logits = logits[i]
                    self.metrics.inc("prefills")
            else:
                slot.next_logits = logits[i]
        self._count_step(prefill_tokens, len(live))

    def _count_step(self, prefill_tokens, n_live):
        self.metrics.inc("steps")
        if prefill_tokens:
            self.metrics.inc("prefill_tokens", prefill_tokens)
        self.metrics.observe_occupancy(n_live, self.max_slots)
        self.metrics.observe_blocks(self._alloc.blocks_in_use,
                                    self._alloc.usable)

    def _observe_step_latency(self, dt, prefill_tokens, n_decoding):
        """Attribute one device step (host clock, through the logits'
        copy to the host) to the 'step' series and to 'prefill' /
        'decode' when it staged prompt tokens / advanced a decoding
        slot."""
        self.metrics.observe_latency("step", dt)
        if prefill_tokens:
            self.metrics.observe_latency("prefill", dt)
        if n_decoding:
            self.metrics.observe_latency("decode", dt)

    def _consume_slots(self, now, tok, nvalid, live):
        """Host-side half of a step: sample each decoding slot's pending
        logits (finish/evict on EOS/max/deadline/cancel), stage the next
        prompt chunk for prefilling slots, and fill the fixed
        [max_slots, chunk] token matrix. Returns the number of prompt
        tokens staged this step."""
        prefill_tokens = 0
        for i, slot in enumerate(self._slots):
            if slot is None or self._drop_dead(i, slot, now):
                continue
            if slot.state == "prefill":
                prefill_tokens += self._stage_prefill(i, slot, tok, nvalid)
                live.append(i)
                continue
            nxt = self._pick(slot)
            slot.tokens.append(nxt)
            slot.produced += 1
            self.metrics.inc("tokens_out")
            if self._finished(slot, nxt):
                self._evict(i)
                continue
            tok[i, 0] = nxt
            slot.advance = 1
            live.append(i)
        return prefill_tokens

    def _drop_dead(self, i, slot, now):
        """Evict a cancelled or expired slot; True when it was."""
        req = slot.req
        if req.cancelled:
            self.metrics.inc("cancelled")
            self._evict(i, RequestCancelled(
                f"request {req.id} cancelled mid-decode"))
            return True
        if req.expired(now):
            self.metrics.inc("timeouts")
            self._evict(i, DeadlineExceededError(
                f"request {req.id} deadline exceeded mid-decode "
                f"after {slot.produced} tokens"))
            return True
        return False

    def _stage_prefill(self, i, slot, tok, nvalid):
        n = min(self.prefill_chunk, slot.prompt_len - slot.fill)
        tok[i, :n] = slot.prompt[slot.fill:slot.fill + n]
        nvalid[i] = n
        slot.advance = n
        return n

    @staticmethod
    def _finished(slot, token):
        gen = slot.req.gen
        eos = gen.get("eos_token_id")
        return (eos is not None and token == eos) or \
            slot.produced >= gen.get("max_new_tokens", 16)

    # -- speculative decoding (spec_len > 0) --------------------------------

    def _step_spec(self):
        """One speculative iteration: pick each decoding slot's
        committed next token, draft up to spec_len proposals per slot
        (catch-up + propose over the shared block tables), stage
        ``[next, d_1..d_s]`` across the chunk columns, run ONE verify
        step, then accept/commit host-side. A fault in the draft phase
        degrades the round to plain decode: proposals are dropped, the
        draft cache keeps whatever catch-up landed, and every slot still
        commits exactly its picked token."""
        try:
            faults.fault_point("serving.step")
        except Exception as e:  # noqa: BLE001 — deterministic mid-decode
            self._fail_all_active(e)
            return
        now = time.monotonic()
        tok = np.zeros((self.max_slots, self.prefill_chunk), np.int32)
        nvalid = np.ones((self.max_slots,), np.int32)
        live: list = []
        plan: list = []   # (slot_idx, slot, next_token, s_i)
        with observe.phase("sample", cat="serving"):
            prefill_tokens = self._consume_spec(now, tok, nvalid, live,
                                                plan)
        if not live:
            return
        # prefilling slots join the draft phase with s_i = 0 so the
        # draft cache ingests their prompt alongside the target prefill
        work = [(i, slot, s_i) for i, slot, _, s_i in plan]
        work += [(i, self._slots[i], 0) for i in live
                 if self._slots[i].state == "prefill"]
        drafted_ok = True
        try:
            faults.fault_point("serving.draft")
            with observe.phase("draft", cat="serving"):
                self._run_draft(work)
        except Exception:  # noqa: BLE001 — degrade to plain decode
            drafted_ok = False
            self.metrics.inc("spec_draft_faults")
        for i, slot, nxt, s_i in plan:
            props = slot.drafted[:s_i] if drafted_ok else []
            slot.spec_staged = props
            tok[i, 0] = nxt
            if props:
                tok[i, 1:1 + len(props)] = props
            nvalid[i] = 1 + len(props)
        faults.fault_point("serving.verify")
        n_pref = sum(1 for i in live
                     if self._slots[i].state == "prefill")
        t0 = time.monotonic()
        with profiler.RecordEvent("serving.step", cat="serving"):
            with observe.phase("device-step", cat="serving"):
                lv, sv, amax = self._device_step(tok, self._pos, nvalid)
                if self.w8a8:
                    self._absorb_act_amax(amax)
        lv = lv.cpu().numpy()
        sv = sv.cpu().numpy()
        self._observe_step_latency(time.monotonic() - t0,
                                   prefill_tokens, len(live) - n_pref)
        for i in live:
            slot = self._slots[i]
            if slot.state == "prefill":
                self._pos[i] += slot.advance
                slot.fill += slot.advance
                self._advance_dfill(slot)
                if slot.fill >= slot.prompt_len:
                    slot.state = "decode"
                    slot.next_logits = lv[i]
                    self.metrics.inc("prefills")
            else:
                self._commit_spec(i, slot, lv[i], sv[i])
        if plan:
            self.metrics.inc("spec_rounds")
        self._count_step(prefill_tokens, len(live))

    def _consume_spec(self, now, tok, nvalid, live, plan):
        """Speculative twin of `_consume_slots`: same cancel / deadline
        / EOS handling and prefill staging, but decoding slots defer
        their token-matrix staging until after the draft phase. Caps
        each slot's draft length at its remaining token budget so every
        staged position stays inside its allocated blocks."""
        prefill_tokens = 0
        for i, slot in enumerate(self._slots):
            if slot is None or self._drop_dead(i, slot, now):
                continue
            if slot.state == "prefill":
                prefill_tokens += self._stage_prefill(i, slot, tok, nvalid)
                live.append(i)
                continue
            gen = slot.req.gen
            if slot.unfed:
                # a residual-resampled token: already committed and
                # EOS-checked last round, its KV write happens now
                nxt = slot.tokens[-1]
                slot.unfed = False
            else:
                nxt = self._pick(slot)
                slot.tokens.append(nxt)
                slot.produced += 1
                self.metrics.inc("tokens_out")
                if self._finished(slot, nxt):
                    self._evict(i)
                    continue
            s_i = min(self.spec_len,
                      gen.get("max_new_tokens", 16) - slot.produced)
            plan.append((i, slot, nxt, s_i))
            live.append(i)
        return prefill_tokens

    def _run_draft(self, work):
        """Drive the draft step until every working slot has caught its
        draft cache up to the committed sequence and sampled its
        proposals. Each iteration batches one [max_slots, spec_len+1]
        call: catch-up slots feed their next committed segment,
        proposing slots feed their latest proposal; idle rows route
        beyond the table so their writes land in the null block.
        Successful feeds are logged to `slot.fed` AFTER the call
        returns, so a mid-phase fault leaves bookkeeping consistent with
        what actually landed in the draft pools."""
        width = self._draft_chunk
        idle_pos = self.blocks_per_slot * self.block_size
        qlast: dict = {}
        limit = -(-self.max_seq_len // width) + self.spec_len + 4
        for _ in range(limit):
            dtok = np.zeros((self.max_slots, width), np.int32)
            dpos = np.full((self.max_slots,), idle_pos, np.int32)
            dnval = np.ones((self.max_slots,), np.int32)
            feeds: dict = {}
            for i, slot, s_i in work:
                base = slot.dfill + len(slot.fed)
                target = slot.tokens
                if base < len(target):
                    n = min(width, len(target) - base)
                    seg = target[base:base + n]
                    dtok[i, :n] = seg
                    dpos[i] = base
                    dnval[i] = n
                    feeds[i] = (slot, seg)
                elif s_i and len(slot.drafted) < s_i:
                    d = self._draft_pick(slot, qlast[i])
                    slot.drafted.append(d)
                    # the FINAL proposal is never fed back: no later
                    # proposal conditions on it, verify recomputes p
                    if len(slot.drafted) < s_i:
                        dtok[i, 0] = d
                        dpos[i] = base
                        dnval[i] = 1
                        feeds[i] = (slot, [d])
            if not feeds:
                return
            with profiler.RecordEvent("serving.draft", cat="serving"):
                lv = self._draft_step(dtok, dpos, dnval)
            lv = lv.cpu().numpy()
            for i, (slot, seg) in feeds.items():
                slot.fed.extend(int(t) for t in seg)
                qlast[i] = lv[i]
        raise RuntimeError(
            f"draft catch-up did not converge in {limit} micro-steps")

    def _draft_pick(self, slot, qrow):
        """Sample one proposal from the draft distribution, recording
        the warped probs (sampling requests) for accept/reject."""
        gen = slot.req.gen
        if not gen.get("do_sample"):
            slot.qdists.append(None)
            return int(qrow.argmax())
        p = self._warp_probs(qrow, gen)
        slot.qdists.append(p)
        return int(slot.rng.choice(p.size, p=p))

    @staticmethod
    def _advance_dfill(slot):
        """Advance the draft-cache coverage mark exactly as far as this
        round's feeds agree with the (post-commit) token sequence:
        committed catch-up and ACCEPTED proposals advance it, a
        rejected suffix or degraded round stops it — the next round's
        catch-up rewrites from there. Clears the round scratch."""
        base, fed, seq = slot.dfill, slot.fed, slot.tokens
        j = 0
        while j < len(fed) and base + j < len(seq) \
                and fed[j] == seq[base + j]:
            j += 1
        slot.dfill = base + j
        slot.fed = []
        slot.drafted = []
        slot.qdists = []

    def _commit_spec(self, i, slot, lv_i, sv_i):
        """Host-side accept/commit for one slot after a verify step.
        Greedy: accept the longest prefix of proposals that match the
        verify argmaxes, then hand the first-mismatch logits row to the
        NEXT round's `_pick` — every emitted token is an argmax of a
        verify row. Sampling: Leviathan accept / residual-resample
        through the identical `_warp_probs` transform
        (`speculative_accept`). All staged positions were scattered
        into the paged pool by the verify step; `self._pos` advances
        only over the committed prefix, and the garbage KV above it is
        overwritten by the next round's staging before any row can
        attend it."""
        props = slot.spec_staged
        slot.spec_staged = []
        gen = slot.req.gen
        s = len(props)
        L = int(self._pos[i])   # position nxt was written at
        if s == 0:
            # plain-decode round (spec budget exhausted or degraded)
            self._pos[i] = L + 1
            slot.next_logits = lv_i
            self._advance_dfill(slot)
            return
        if not gen.get("do_sample"):
            a = 0
            while a < s and int(sv_i[a].argmax()) == props[a]:
                a += 1
            resampled = None
            # rejection: sv_i[a] is p(. | accepted prefix) — the next
            # _pick's argmax IS the rejection token; all-accept: the
            # bonus row
            nl = sv_i[a] if a < s else sv_i[s]
        else:
            p_list = [self._warp_probs(sv_i[j], gen) for j in range(s)]
            a, resampled = speculative_accept(p_list, slot.qdists[:s],
                                              props, slot.rng)
            nl = None if resampled is not None else sv_i[s]
        self.metrics.observe_spec(i, s, a)
        finished = False
        m = 0
        for t in props[:a]:
            slot.tokens.append(int(t))
            slot.produced += 1
            self.metrics.inc("tokens_out")
            m += 1
            if self._finished(slot, t):
                finished = True
                break
        self._pos[i] = L + 1 + m
        self._advance_dfill(slot)
        if finished:
            self._evict(i)
            return
        if resampled is not None:
            slot.tokens.append(int(resampled))
            slot.produced += 1
            self.metrics.inc("tokens_out")
            slot.next_logits = None
            slot.unfed = True
            if self._finished(slot, resampled):
                slot.unfed = False
                self._evict(i)
            return
        slot.next_logits = nl

    # -- serve loop ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._abort.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def _beat(self):
        """One liveness heartbeat per loop iteration. The fault point
        fires only for supervised (fleet-owned) engines, so a standalone
        engine's loop never consumes fleet fault occurrences; a `delay`
        here stalls the beat (the watchdog declares the replica dead), a
        `raise` kills the engine THREAD (detected as a crash)."""
        if self.supervised:
            faults.fault_point("serving.replica_heartbeat", tag=self.name)
        self.heartbeats += 1
        self.last_beat = time.monotonic()

    def _loop(self):
        import contextlib

        if self.device.type == "cuda":
            # the kernels launch on the current device's current stream,
            # both read in this thread
            torch.cuda.set_device(self.device)
        guard = observe.no_retrace() if self._strict and self._warmed \
            else contextlib.nullcontext()
        with guard:
            self._serve()

    def _serve(self):
        while True:
            self._beat()
            with self._host_lock:
                self._drain_adoptions()
                self._drain_adapter_swaps()
                if self._abort.is_set():
                    self._fail_all_active(
                        self._abort_error or RequestCancelled(
                            "server aborted (non-drain shutdown)"))
                    return
                self._admit()
                active = self.active
            if active == 0:
                if self.queue.drained():
                    return
                self.queue.wait_nonempty(0.02)
                continue
            with self._host_lock:
                try:
                    if self.supervised:
                        faults.fault_point("serving.replica_step",
                                           tag=self.name)
                    self._step()
                except Exception as e:  # noqa: BLE001 — engine stays up
                    # the error reaches every in-flight request's future
                    self.metrics.inc("step_errors")
                    self._fail_all_active(e)

    def abandon(self, error):
        """Supervisor-side takeover of a dead or hung replica: stop the
        loop at its next boundary and fail every in-flight and queued
        request with `error` (typically `ReplicaDiedError`, which the
        fleet Router intercepts and replays elsewhere). Never joins the
        thread: a hung replica's thread may sleep inside an injected
        delay (or real stuck I/O) for a long time; it keeps this
        engine's pools and weights alive until it wakes and exits."""
        self._abort_error = error
        self._abort.set()
        self.queue.close(drain=False)
        # a thread already dead (crashed loop) never reaches the abort
        # branch: sweep its stranded slots from the supervisor thread
        if self._thread is not None and not self._thread.is_alive():
            with self._host_lock:
                self._fail_all_active(error)

    def shutdown(self, drain=True, timeout=None):
        """Stop. drain=True finishes queued + in-flight requests first
        (and then persists the radix cache through the spill tier, so
        sessions resume decode-only after a clean restart);
        drain=False sheds the queue and evicts in-flight requests at
        the next step boundary."""
        self.queue.close(drain=drain)
        if not drain:
            self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if drain and self.spill_store is not None:
            self.spill_cache()
