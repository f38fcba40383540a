"""In-process serving front over one `SlotEngine` (the single-engine
``mode="generate"`` part of paddle_tpu/serving/server.py; the fleet
Router, batch mode and the HTTP front are not ported yet).

    cfg = GPTConfig(..., use_parallel=False)
    model = GPTForPretraining(cfg)                 # on cuda
    with Server(model, max_slots=8, quantize=True, w8a8=True) as srv:
        ids = srv.generate([1, 2, 3], max_new_tokens=8)
        print(srv.snapshot()["tokens_per_s"])
"""

from __future__ import annotations

from ..framework.flags import flag
from .engine import SlotEngine
from .metrics import ServingMetrics
from .queueing import AdmissionQueue

__all__ = ["Server"]


class Server:
    """Serving front: admission queue + continuous-batching engine +
    metrics. Engine knobs (``max_slots``, ``block_size``,
    ``prefill_chunk``, ``quantize``, ``w8a8``, ``device`` ...) are
    forwarded to `SlotEngine`."""

    def __init__(self, model=None, *, mode="generate", max_slots=None,
                 max_seq_len=None, block_size=None, num_blocks=None,
                 prefill_chunk=None, prefix_cache=None, queue_cap=None,
                 warmup=True, quantize=None, w8a8=None, device=None):
        if mode != "generate":
            raise ValueError(
                f"serving mode {mode!r} is not ported; only 'generate'")
        if model is None:
            raise ValueError("generate mode needs a GPT model")
        self.mode = mode
        self.metrics = ServingMetrics()
        self._warmup = warmup
        cap = queue_cap or flag("FLAGS_serving_queue_cap")
        self.engine = SlotEngine(
            model, max_slots=max_slots, max_seq_len=max_seq_len,
            block_size=block_size, num_blocks=num_blocks,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            metrics=self.metrics,
            queue=AdmissionQueue(cap, metrics=self.metrics),
            quantize=quantize, w8a8=w8a8, device=device)
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if not self._started:
            if self._warmup and not self.engine._warmed:
                self.engine.warmup()
            self.engine.start()
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
        self.engine.shutdown(drain=drain)

    # -- request API --------------------------------------------------------

    def queue_depth(self):
        return self.engine.queue.depth

    def submit(self, payload, **kw):
        """Admit one 1-D prompt; returns a `Request` future."""
        if not self._started:
            self.start()
        return self.engine.submit(payload, **kw)

    def generate(self, prompt_ids, timeout=None, **kw):
        """Synchronous submit+wait."""
        return self.submit(prompt_ids, **kw).result(timeout)

    def snapshot(self):
        return self.metrics.snapshot(queue_depth=self.queue_depth())
