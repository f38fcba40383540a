"""Continuous-batching decode engine over a block-paged KV cache
(counterpart of paddle_tpu/serving/engine.py, single device).

- ONE physical block pool per layer, ``[num_blocks, nh, block_size,
  hd]``, plus a per-slot block table ``[max_slots, blocks_per_slot]``.
  A request holds only the blocks its length needs.
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

Differences from the reference, by design: the KV pools are updated IN
PLACE (the reference returns new pools); there is no compiled trace
(PyTorch runs eagerly), so there are no compile counters — the kernels'
launch counters show the path instead. Left for later slices:
speculative decoding, LoRA banks, the KV spill tier, mesh sharding, KV
adoption/migration, fault sites and fleet supervision.

Logits come to the host once per step (``logits.cpu().numpy()``) and
sampling stays numpy ``RandomState`` per request, exactly as in the
reference, so sampled tokens agree too given equal logits.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
from torch.func import functional_call

from .. import resolve_device
from ..framework.flags import flag
from ..ops import lowp, quant_ops
from ..quantization import (
    SCALE_SUFFIX, dequantize_state, is_quantized_state, quantize_state_int8,
)
from .metrics import ServingMetrics
from .paging import NULL_BLOCK, BlockAllocator, PoolExhausted, PrefixCache
from .queueing import (
    AdmissionQueue, CapacityExhaustedError, DeadlineExceededError, Request,
    RequestCancelled,
)

__all__ = ["SlotEngine"]


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


class _StepNet(torch.nn.Module):
    """The model's trunk over the paged caches plus the gather of each
    slot's last valid row, run through `torch.func.functional_call` so
    that every step can swap in freshly dequantized weights."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tok, posmat, nvalid, caches, project):
        h, _ = self.model.gpt(tok, posmat, caches=caches)
        last = h[torch.arange(h.shape[0], device=h.device), nvalid - 1]
        return last, (self.model.logits(last) if project else None)


class SlotEngine:
    """Continuous-batching greedy/sampling decode over a GPT model.

    `model` is a `GPTForPretraining` on `device` (default cuda; an
    engine asked for cuda without a visible GPU raises). Requests carry
    `max_new_tokens`, optional `eos_token_id`, and sampling params;
    results are the full [prompt + generated] int32 id array.
    """

    # warmup + this many real steps feed the running abs-max before the
    # activation scale freezes
    _W8A8_CALIB_STEPS = 8

    def __init__(self, model, *, max_slots=None, max_seq_len=None,
                 block_size=None, num_blocks=None, prefill_chunk=None,
                 prefix_cache=None, metrics=None, queue=None, values=None,
                 quantize=None, w8a8=None, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device} but the engine runs on "
                f"{self.device}; build both on one device")
        model.eval()
        self.model = model
        self._net = _StepNet(model)
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
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.queue = queue if queue is not None else AdmissionQueue(
            flag("FLAGS_serving_queue_cap"), metrics=self.metrics)
        if values is not None:
            self._values = {k: torch.as_tensor(v, device=self.device)
                            for k, v in values.items()}
        else:
            self._values = dict(model.state_dict())
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
        if self.w8a8:
            self.metrics.set_gauge("w8a8_path", 1.0)
        hd = cfg.hidden_size // cfg.num_heads
        shape = (self.num_blocks, cfg.num_heads, self.block_size, hd)
        self._ks = [torch.zeros(shape, device=self.device)
                    for _ in range(cfg.num_layers)]
        self._vs = [torch.zeros(shape, device=self.device)
                    for _ in range(cfg.num_layers)]
        self.kv_pool_bytes = int(
            2 * cfg.num_layers * np.prod(shape) * self._ks[0].element_size())
        self._alloc = BlockAllocator(self.num_blocks)
        if prefix_cache is None:
            prefix_cache = flag("FLAGS_serving_prefix_cache")
        self._cache = PrefixCache(self._alloc, self.block_size) \
            if prefix_cache else None
        self._pos = np.zeros((self.max_slots,), np.int32)
        self._bt = np.full((self.max_slots, self.blocks_per_slot),
                           NULL_BLOCK, np.int32)
        self._slots: list = [None] * self.max_slots
        self._free = list(range(self.max_slots))
        self._warmed = False
        self._abort = threading.Event()
        self._thread = None

    # -- introspection ------------------------------------------------------

    @property
    def active(self):
        return sum(1 for s in self._slots if s is not None)

    def _blocks_needed(self, n_positions):
        return -(-int(n_positions) // self.block_size)

    # -- the device step ----------------------------------------------------

    def _head(self, last):
        """Project the slots' last hidden rows [S, H] to f32 logits [S, V]
        against the frozen int8 tied table: B8 (w8a8) once the
        activation scale has absorbed a step, else B7."""
        qk, sk = self._head_key
        q, s = self._values[qk], self._values[sk]
        if self.w8a8 and self._act_calib > 0:
            # the [V, H] table's transpose, read in place by the kernel
            return lowp.w8a8_matmul(last, q.t(), s, self._act_scale)
        return quant_ops.dequant_matmul(last, q, s)

    def _device_step(self, tok, pos, nvalid):
        """One step over the whole pool: scatter the chunk's KV into the
        paged pools (in place), return the f32 logits of each slot's
        last valid row and, for w8a8, that row block's abs-max."""
        dev = self.device

        def arg(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        tok_t, pos_t, nv_t, bt_t = arg(tok), arg(pos), arg(nvalid), \
            arg(self._bt)
        with torch.no_grad():
            # clamp padding rows' position ids into the embedding table;
            # their KV writes route to the null block regardless
            posmat = torch.clamp(
                pos_t[:, None] + torch.arange(tok_t.shape[1], device=dev),
                max=self.max_seq_len - 1)
            caches = [(k, v, (pos_t, bt_t))
                      for k, v in zip(self._ks, self._vs)]
            fvals = dequantize_state(self._values) if self.quantized \
                else self._values
            project = self._head_key is None
            last, logits = functional_call(
                self._net, {"model." + k: v for k, v in fvals.items()},
                (tok_t, posmat, nv_t, caches, project))
            if not project:
                logits = self._head(last)
            amax = last.float().abs().max() if self.w8a8 else None
        return logits.float(), amax

    def _absorb_act_amax(self, amax):
        """Fold one step's head-input abs-max into the activation scale
        (device ops only — no host sync)."""
        if self._act_frozen:
            return
        self._act_scale = torch.maximum(self._act_scale, amax)
        self._act_calib += 1
        if self._act_calib > self._W8A8_CALIB_STEPS:
            self._act_frozen = True

    def _cow(self, src, dst):
        """Copy-on-write: physical block `src` -> `dst` in every pool."""
        for pool in self._ks + self._vs:
            pool[dst].copy_(pool[src])

    # -- warmup -------------------------------------------------------------

    def warmup(self):
        """Run one dummy step before traffic: every table points at the
        null block, so its writes land in reserved scratch. Builds the
        head kernel on first use and, for w8a8, absorbs the first
        activation abs-max."""
        tok = np.zeros((self.max_slots, self.prefill_chunk), np.int32)
        pos = np.zeros((self.max_slots,), np.int32)
        nvalid = np.ones((self.max_slots,), np.int32)
        _, amax = self._device_step(tok, pos, nvalid)
        if self.w8a8:
            self._absorb_act_amax(amax)
        self._warmed = True

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt_ids, *, max_new_tokens=16, eos_token_id=None,
               timeout=None, do_sample=False, temperature=1.0, top_k=0,
               seed=0):
        """Admit one request (or shed); returns its `Request` future.

        Length beyond the model's positional range is a hard
        `ValueError`; a request whose block demand exceeds the whole
        physical pool sheds with the retriable `CapacityExhaustedError`."""
        if timeout is None:
            timeout = flag("FLAGS_serving_default_timeout_s") or None
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
            ids, timeout=timeout, max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            seed=seed))

    def _stage_blocks(self, ids, need_total):
        """Reserve the physical blocks for one admission: reuse every
        prefix-cached block, allocate the rest, copy-on-write when the
        divergence falls inside a cached block. Returns ``(blocks,
        fill)`` or raises (`PoolExhausted` = wait and retry). All-or-
        nothing: partial reservations are rolled back."""
        shared, n_shared, cow = [], 0, None
        if self._cache is not None:
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
            self._slots[slot] = _Slot(req, ids, fill, blocks)
            self.metrics.inc("admitted")
            self.metrics.observe_latency(
                "queue", time.monotonic() - req.arrival)

    @staticmethod
    def _warp_probs(logits, gen):
        """Temperature + top-k warped softmax, the transform `_pick`
        samples from."""
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
        if error is not None:
            self.metrics.inc("failed")
            slot.req._fail(error)
        else:
            self.metrics.inc("completed")
            self.metrics.observe_latency(
                "e2e", time.monotonic() - slot.req.arrival)
            slot.req._complete(np.asarray(slot.tokens, np.int32))

    def _fail_all_active(self, error):
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._evict(i, error)

    def _step(self):
        """One continuous-batching iteration: consume each decoding
        slot's pending logits (finishing slots that hit
        EOS/max/deadline), stage the next chunk for prefilling slots,
        then ONE batched step over the whole pool."""
        now = time.monotonic()
        tok = np.zeros((self.max_slots, self.prefill_chunk), np.int32)
        nvalid = np.ones((self.max_slots,), np.int32)
        live: list = []
        prefill_tokens = self._consume_slots(now, tok, nvalid, live)
        if not live:
            return
        n_pref = sum(1 for i in live
                     if self._slots[i].state == "prefill")
        t0 = time.monotonic()
        logits, amax = self._device_step(tok, self._pos, nvalid)
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
        self.metrics.inc("steps")
        if prefill_tokens:
            self.metrics.inc("prefill_tokens", prefill_tokens)
        self.metrics.observe_occupancy(len(live), self.max_slots)
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
            if slot is None:
                continue
            req = slot.req
            if req.cancelled:
                self.metrics.inc("cancelled")
                self._evict(i, RequestCancelled(
                    f"request {req.id} cancelled mid-decode"))
                continue
            if req.expired(now):
                self.metrics.inc("timeouts")
                self._evict(i, DeadlineExceededError(
                    f"request {req.id} deadline exceeded mid-decode "
                    f"after {slot.produced} tokens"))
                continue
            if slot.state == "prefill":
                n = min(self.prefill_chunk, slot.prompt_len - slot.fill)
                tok[i, :n] = slot.prompt[slot.fill:slot.fill + n]
                nvalid[i] = n
                slot.advance = n
                prefill_tokens += n
                live.append(i)
                continue
            nxt = self._pick(slot)
            slot.tokens.append(nxt)
            slot.produced += 1
            self.metrics.inc("tokens_out")
            gen = req.gen
            eos = gen.get("eos_token_id")
            if (eos is not None and nxt == eos) or \
                    slot.produced >= gen.get("max_new_tokens", 16):
                self._evict(i)
                continue
            tok[i, 0] = nxt
            slot.advance = 1
            live.append(i)
        return prefill_tokens

    # -- serve loop ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._abort.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        if self.device.type == "cuda":
            # the kernels launch on the current device's current stream,
            # both read in this thread
            torch.cuda.set_device(self.device)
        while True:
            if self._abort.is_set():
                self._fail_all_active(RequestCancelled(
                    "server aborted (non-drain shutdown)"))
                return
            self._admit()
            if self.active == 0:
                if self.queue.drained():
                    return
                self.queue.wait_nonempty(0.02)
                continue
            try:
                self._step()
            except Exception as e:  # noqa: BLE001 — engine stays up
                # the error reaches every in-flight request's future
                self.metrics.inc("step_errors")
                self._fail_all_active(e)

    def shutdown(self, drain=True, timeout=None):
        """Stop. drain=True finishes queued + in-flight requests first;
        drain=False sheds the queue and evicts in-flight requests at the
        next step boundary."""
        self.queue.close(drain=drain)
        if not drain:
            self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
