"""In-process serving front: one object tying admission control, the
continuous-batching engine (or the dynamic batcher, or the resilient
fleet), and metrics (counterpart of paddle_tpu/serving/server.py).

    cfg = GPTConfig(..., use_parallel=False)
    model = GPTForPretraining(cfg)                 # on cuda
    with Server(model, max_slots=8, quantize=True, spec_len=3) as srv:
        ids = srv.generate([1, 2, 3], max_new_tokens=8)
        print(srv.snapshot()["tokens_per_s"])

    with Server(model, replicas=2, quantize=True,
                tenancy=TenantDirectory({"a": {"weight": 3}})) as srv:
        httpd = http_front(srv, port=0)            # /v1/generate ...

    with Server(mode="batch", fn=classify, max_batch=32) as srv:
        logits = srv.submit(sample).result()

``replicas=N`` (N >= 2, or any ``fleet=dict(...)``) serves through the
fleet (`fleet.Router`): N supervised engine replicas on one device with
failover replay, retries, hedging, circuit breakers and brownout — the
same `submit()/generate()` API, plus ``priority=`` and ``tenant=``.
Extra Router knobs ride in ``fleet=dict(...)``. `http_front` is the
stdlib HTTP front door over any of them.

`metrics_prometheus()` is this server's Prometheus text
(`observe.prometheus_text`, with the fleet's per-replica gauges in
fleet mode); `http_front`'s ``GET /metrics`` serves it to scrapers.
Waiting in this port: `Server.from_predictor` (the inference package)
and ``http_front(ranker=)`` / ``/v1/rank`` (the rec package).
"""

from __future__ import annotations

import json
import threading

import numpy as np

from ..framework.flags import flag
from .batcher import DynamicBatcher
from .engine import SlotEngine
from .metrics import ServingMetrics
from .queueing import AdmissionQueue, ServingError, TenantFairQueue

__all__ = ["Server", "http_front"]


class Server:
    """Serving front over a model.

    mode="generate" (default): `model` is a GPTForPretraining; requests
    are prompts and the backend is the continuous-batching `SlotEngine`
    (or, with ``replicas`` > 1 or ``fleet``, a `fleet.Router` over
    replica engines). Engine knobs are forwarded to every engine:
    ``max_slots``, ``block_size``, ``prefill_chunk``, ``cache_dtype``
    (the KV pools' dtype), ``quantize`` / ``w8a8`` (the int8 heads),
    ``spec_len`` / ``draft_model`` (speculative decoding, self-draft
    when no draft model is given), ``spill_dir`` (the SSD KV spill
    tier), ``max_adapters`` / ``lora_rank`` (the batched LoRA bank;
    ``submit(..., adapter_id=k)``), ``device`` ... Defaults come from
    the FLAGS_serving_* flags. ``tenancy=TenantDirectory(...)``
    switches admission to weighted-fair per-tenant queues with token
    budgets and tier-based brownout (``submit(..., tenant=name)``).

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
                 cache_dtype=None, warmup=True, replicas=1, fleet=None,
                 spec_len=None, draft_model=None, quantize=None, w8a8=None,
                 spill_dir=None, max_adapters=None, lora_rank=None,
                 tenancy=None, device=None):
        self.mode = mode
        self.metrics = ServingMetrics()
        self._warmup = warmup
        self.engine = self.batcher = self.router = None
        self.tenancy = tenancy
        engine_kw = dict(
            max_slots=max_slots, max_seq_len=max_seq_len,
            block_size=block_size, num_blocks=num_blocks,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            cache_dtype=cache_dtype, spec_len=spec_len,
            draft_model=draft_model, quantize=quantize, w8a8=w8a8,
            spill_dir=spill_dir, max_adapters=max_adapters,
            lora_rank=lora_rank, device=device)
        if mode == "generate" and model is None:
            raise ValueError("generate mode needs a GPT model")
        if mode == "generate" and (replicas > 1 or fleet is not None):
            from .fleet import Router

            fleet_kw = dict(fleet or {})
            if tenancy is not None:
                fleet_kw.setdefault("tenancy", tenancy)
            self.router = Router(
                model, max(replicas, 1), engine_kw=engine_kw,
                metrics=self.metrics, queue_cap=queue_cap,
                warmup=warmup, **fleet_kw)
        elif mode == "generate":
            cap = queue_cap or flag("FLAGS_serving_queue_cap")
            if tenancy is not None:
                queue = TenantFairQueue(cap, tenancy=tenancy,
                                        metrics=self.metrics)
            else:
                queue = AdmissionQueue(cap, metrics=self.metrics)
            self.engine = SlotEngine(model, metrics=self.metrics,
                                     queue=queue, **engine_kw)
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

    @classmethod
    def from_router(cls, router):
        """Wrap an already-built (and possibly already-started) fleet
        Router so `http_front` / `version_info()` / `snapshot()` serve
        it. The wrapper shares the Router's metrics and owns no
        lifecycle beyond forwarding start/shutdown."""
        srv = cls.__new__(cls)
        srv.mode = "generate"
        srv.metrics = router.metrics
        srv._warmup = False
        srv.router = router
        srv.engine = srv.batcher = None
        srv.tenancy = router.tenancy
        srv._started = router._sup is not None
        return srv

    @property
    def _backend(self):
        return self.router or self.engine or self.batcher

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
        Idempotent: a server never started, or already shut down, is a
        no-op."""
        if not self._started:
            return
        self._started = False
        if self.batcher is not None:
            self.batcher.close(drain=drain)
        else:
            self._backend.shutdown(drain=drain)

    # -- request API --------------------------------------------------------

    @property
    def queue(self):
        """The single backend's admission queue (engine / batcher
        modes). Fleet mode has one queue per replica: use
        `queue_depth()`."""
        if self.router is not None:
            raise AttributeError(
                "fleet mode has a queue per replica; use queue_depth()")
        return self._backend.queue

    def queue_depth(self):
        if self.router is not None:
            return self.router.queue_depth
        return self._backend.queue.depth

    def submit(self, payload, **kw):
        """Admit one request; returns a `Request` future. Generate mode
        takes a 1-D prompt + generation kwargs (``priority=`` and
        ``tenant=`` included), batch mode one sample."""
        if not self._started:
            self.start()
        return self._backend.submit(payload, **kw)

    def generate(self, prompt_ids, timeout=None, **kw):
        """Synchronous submit+wait."""
        return self.submit(prompt_ids, **kw).result(timeout)

    def snapshot(self):
        snap = self.metrics.snapshot(queue_depth=self.queue_depth())
        if self.router is not None:
            snap["fleet"] = self.router.snapshot()
        return snap

    def version_info(self):
        """Model-version view: current / previous version ids, rollout
        state and the per-replica version map (`GET /v1/version` over
        `http_front` returns exactly this). Fleet mode delegates to the
        Router (which folds in an attached `RolloutController`); a
        single-engine server is always `static` on its build version."""
        if self.router is not None:
            return self.router.version_info()
        if self.engine is not None:
            v = self.engine.weight_version
            return {"current": v, "previous": None, "target": None,
                    "state": "static", "error": None,
                    "versions_live": [v],
                    "replicas": {self.engine.name: v}}
        return {"current": 0, "previous": None, "target": None,
                "state": "static", "error": None,
                "versions_live": [], "replicas": {}}

    def metrics_json(self, **kw):
        return json.dumps(self.snapshot(), **kw)

    def metrics_prometheus(self):
        """Prometheus text exposition of this server's metrics unified
        with the global monitor/timeline/goodput registries
        (observe.prometheus_text); fleet mode adds the per-replica
        state/restart/breaker gauges."""
        from .. import observe

        fleet = self.router.snapshot() if self.router is not None else None
        return observe.prometheus_text(serving=self.metrics,
                                       queue_depth=self.queue_depth(),
                                       fleet=fleet)


def http_front(server, host="127.0.0.1", port=0):
    """Stdlib HTTP front door over a `Server`. POST /v1/generate with a
    JSON body ``{"prompt": [ids...], "max_new_tokens": n, ...}`` returns
    ``{"ids": [...]}``; GET /metrics returns the JSON snapshot (the
    Prometheus text of `Server.metrics_prometheus` when the client asks
    with ``Accept: text/plain`` or openmetrics, or with
    ``?format=prometheus``) and GET /v1/version the model-version view
    (current / previous ids, rollout state, per-replica version map).
    Serving errors map to their HTTP status (429 shed, 504 deadline, 503
    version retired ...) with a ``Retry-After`` backoff hint on 429 /
    503, and every error body says whether the client may retry. A
    request may carry its tenant as an ``X-Tenant`` header or a
    ``tenant`` body field (the body wins); a tenant over its token
    budget gets a 429 whose
    ``Retry-After`` is its own bucket's refill time.

    Returns the started `ThreadingHTTPServer`; its bound port is
    ``httpd.server_address[1]``. Call ``httpd.shutdown()`` and
    ``httpd.server_close()`` to stop it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code, obj, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code, text,
                        ctype="text/plain; version=0.0.4; charset=utf-8"):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                # content negotiation: the JSON snapshot by default (a
                # bare GET keeps working), the Prometheus exposition
                # when a scraper asks for it
                accept = self.headers.get("Accept", "")
                if ("format=prometheus" in query
                        or "text/plain" in accept
                        or "openmetrics" in accept):
                    self._reply_text(200, server.metrics_prometheus())
                else:
                    self._reply(200, server.snapshot())
            elif path == "/v1/version":
                self._reply(200, server.version_info())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                xt = self.headers.get("X-Tenant")
                if xt and not req.get("tenant"):
                    req["tenant"] = xt
                if self.path != "/v1/generate":
                    self._reply(404, {"error": "not found"})
                    return
                prompt = req.pop("prompt")
                timeout = req.pop("timeout", None)
                out = server.generate(prompt, timeout=timeout, **req)
                self._reply(200, {"ids": np.asarray(out).tolist()})
            except ServingError as e:
                # the in-process Router's backoff contract, mirrored:
                # `retriable` says whether resubmitting the identical
                # request can succeed; overload / unavailable carry a
                # Retry-After (a TenantBudgetError's is its bucket's)
                headers = {}
                if e.status in (429, 503):
                    headers["Retry-After"] = f"{e.retry_after_s:g}"
                self._reply(e.status, {
                    "error": str(e), "type": type(e).__name__,
                    "retriable": bool(e.retriable)}, headers=headers)
            except Exception as e:  # noqa: BLE001 — bad request shape
                self._reply(400, {"error": str(e), "retriable": False})

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, name="serving-http",
                     daemon=True).start()
    return httpd
