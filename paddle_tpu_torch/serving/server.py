"""In-process serving front over one `SlotEngine` or one
`DynamicBatcher` (the single-backend part of
paddle_tpu/serving/server.py; the fleet Router, tenancy and the HTTP
front are not ported yet).

    cfg = GPTConfig(..., use_parallel=False)
    model = GPTForPretraining(cfg)                 # on cuda
    with Server(model, max_slots=8, quantize=True, spec_len=3) as srv:
        ids = srv.generate([1, 2, 3], max_new_tokens=8)
        print(srv.snapshot()["tokens_per_s"])

    with Server(mode="batch", fn=classify, max_batch=32) as srv:
        logits = srv.submit(sample).result()
"""

from __future__ import annotations

from ..framework.flags import flag
from .batcher import DynamicBatcher
from .engine import SlotEngine
from .metrics import ServingMetrics
from .queueing import AdmissionQueue

__all__ = ["Server"]


class Server:
    """Serving front over a model.

    mode="generate" (default): `model` is a GPTForPretraining; requests
    are prompts and the backend is the continuous-batching `SlotEngine`.
    Engine knobs are forwarded to it: ``max_slots``, ``block_size``,
    ``prefill_chunk``, ``cache_dtype`` (the KV pools' dtype),
    ``quantize`` / ``w8a8`` (the int8 heads), ``spec_len`` /
    ``draft_model`` (speculative decoding, self-draft when no draft
    model is given), ``spill_dir`` (the SSD KV spill tier),
    ``max_adapters`` / ``lora_rank`` (the batched LoRA bank;
    ``submit(..., adapter_id=k)``), ``device`` ... Defaults come from
    the FLAGS_serving_* flags.

    mode="batch": `fn` is a batch function (or pass a callable as
    `model`) mapping a numpy batch [n, ...] to outputs with leading
    axis n; requests are single samples coalesced by the
    `DynamicBatcher`, whose worker thread calls `fn` — so `fn` enters
    its own autocast, which is thread-local.
    """

    def __init__(self, model=None, *, mode="generate", fn=None,
                 max_slots=None, max_seq_len=None, block_size=None,
                 num_blocks=None, prefill_chunk=None, prefix_cache=None,
                 queue_cap=None, max_batch=None, max_wait_s=0.002,
                 cache_dtype=None, warmup=True, spec_len=None,
                 draft_model=None, quantize=None, w8a8=None, spill_dir=None,
                 max_adapters=None, lora_rank=None, device=None):
        self.mode = mode
        self.metrics = ServingMetrics()
        self._warmup = warmup
        self.engine = self.batcher = None
        if mode == "generate":
            if model is None:
                raise ValueError("generate mode needs a GPT model")
            cap = queue_cap or flag("FLAGS_serving_queue_cap")
            self.engine = SlotEngine(
                model, max_slots=max_slots, max_seq_len=max_seq_len,
                block_size=block_size, num_blocks=num_blocks,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                cache_dtype=cache_dtype, metrics=self.metrics,
                queue=AdmissionQueue(cap, metrics=self.metrics),
                spec_len=spec_len, draft_model=draft_model,
                quantize=quantize, w8a8=w8a8, spill_dir=spill_dir,
                max_adapters=max_adapters, lora_rank=lora_rank,
                device=device)
        elif mode == "batch":
            target = fn if fn is not None else model
            if target is None or not callable(target):
                raise ValueError("batch mode needs a callable fn")
            self.batcher = DynamicBatcher(
                target, max_batch=max_batch, max_wait_s=max_wait_s,
                queue_cap=queue_cap, metrics=self.metrics)
        else:
            raise ValueError(f"unknown serving mode {mode!r}")
        self._started = False

    @property
    def _backend(self):
        return self.engine or self.batcher

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if not self._started:
            if self.engine is not None and self._warmup \
                    and not self.engine._warmed:
                self.engine.warmup()
            self._backend.start()
            self._started = True
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)
        return False

    def shutdown(self, drain=True):
        """Graceful drain (finish queued + in-flight work) or fast stop.
        Idempotent."""
        if not self._started:
            return
        self._started = False
        if self.engine is not None:
            self.engine.shutdown(drain=drain)
        else:
            self.batcher.close(drain=drain)

    # -- request API --------------------------------------------------------

    @property
    def queue(self):
        return self._backend.queue

    def queue_depth(self):
        return self._backend.queue.depth

    def submit(self, payload, **kw):
        """Admit one request; returns a `Request` future. Generate mode
        takes a 1-D prompt + generation kwargs, batch mode one sample."""
        if not self._started:
            self.start()
        return self._backend.submit(payload, **kw)

    def generate(self, prompt_ids, timeout=None, **kw):
        """Synchronous submit+wait."""
        return self.submit(prompt_ids, **kw).result(timeout)

    def snapshot(self):
        return self.metrics.snapshot(queue_depth=self.queue_depth())
