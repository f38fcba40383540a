#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (paddle_tpu_torch) on one
card. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device line: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; build every kernel from csrc/ (one nvcc per source,
   in parallel — set-up time).
2. Kernels at the serving shape (M=8, K=768, N=50304) and two ragged
   shapes: B7 `dequant_matmul` against its plain version (rtol=atol=
   1e-5, f32, TF32 off), B8 `w8a8_matmul` bitwise. Times (CUDA events,
   median of 50 launches, L2 flushed before each) of the kernel, its
   plain version and the one-call PyTorch yardstick where one exists,
   beside the card's least time for the same bytes and operations.
3. The slice against its plain version: a tiny GPT with the same
   weights on cuda and on the CPU, three pinned prompts through the
   int8 and the w8a8 engines; greedy tokens must agree.
4. Full width: gpt2-small (vocab 50304, hidden 768, 12 layers, 12
   heads, max_seq_len 1024), random weights from seed 0, served by
   `Server(mode="generate")` with max_slots=8, block_size=16,
   prefill_chunk=64 in three legs (f32, int8, w8a8): 16 greedy
   requests, prompt lengths 32-256 from a seeded RNG, half of them
   sharing a 64-token prefix, 32 new tokens each. Kernel launch counts
   are set to 0 just before each leg and read just after it.
5. Where a decode step's time goes: host step time, device kernel time
   and launches per step of the w8a8 engine, from torch.profiler.

The last lines are the card line, one ``{"kernels": [...]}`` JSON line
and ``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it exits with status 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks: memory bytes/s, f32 (non-tensor) flop/s,
# dense int8 tensor op/s; H100 SXM rates unless the name says otherwise
_PEAKS = (
    ("H200", (4.8e12, 67e12, 1979e12)),
    ("H100 PCIe", (2.0e12, 51e12, 1513e12)),
    ("H100 NVL", (3.9e12, 60e12, 1671e12)),
    ("H100", (3.35e12, 67e12, 1979e12)),
)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _peaks(name):
    for key, peaks in _PEAKS:
        if key in name:
            return peaks
    return _PEAKS[-1][1]


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, flush, n=50):
    """Median device time of `fn` over `n` launches (CUDA events around
    each). Before every launch the 50 MB L2 is flushed by reading a
    128 MB buffer (in the serving step the layers between two heads
    evict the table), and the card then spins ~0.1 ms so that the host
    has enqueued the launch before the start event fires: the events
    time the device, not the wrapper's Python."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        flush.sum()
        torch.cuda._sleep(200_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def _table(n, k, gen):
    """A frozen int8 table like the engine's: a N(0, 0.02) embedding
    quantized per tensor."""
    import torch

    from paddle_tpu_torch.quantization import quantize_state_int8

    w = torch.empty((n, k)).normal_(0.0, 0.02, generator=gen)
    frozen = quantize_state_int8({"w": w})
    return frozen["w"], frozen["w@scale"]


def phase_kernels(card):
    """Phase 2: B7 and B8 against their plain versions, then timed."""
    import torch

    from paddle_tpu_torch.ops import lowp, quant_ops

    gen = torch.Generator().manual_seed(0)
    errs = {"B7": 0.0, "B8": 0.0}
    shapes = [(8, 768, 50304), (3, 100, 333), (13, 2100, 777)]
    for m, k, n in shapes:
        q, s = (t.cuda() for t in _table(n, k, gen))
        x = torch.randn((m, k), generator=gen).cuda()
        per_row = (q.float().abs().amax(1) / 127.0 * s).cuda()
        for sc in (s, per_row):
            got = quant_ops.dequant_matmul(x, q, sc)
            want = quant_ops._dequant_matmul_plain(x, q, sc.reshape(-1))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs["B7"] = max(errs["B7"], (got - want).abs().max().item())
        # the engine's frozen scale (the abs-max) and one that clips
        for sa in (x.abs().max(), x.abs().max() * 0.9):
            for table in (q.t(), q.t().contiguous()):
                got = lowp.w8a8_matmul(x, table, s, sa)
                want = lowp._w8a8_plain(x, table, s, sa)
                torch.cuda.synchronize()
                _check(torch.equal(got, want),
                       f"B8 differs from its plain version at {(m, k, n)}")
        print(f"kernels ok at M={m} K={k} N={n}", flush=True)
    # B8 on the rounding boundaries: x * (127 / sa) lands on k + 0.5
    sa = torch.tensor(3.7)
    x = ((torch.arange(-127, 127) + 0.5) * sa / 127.0).repeat(8, 1)
    q = torch.randint(-127, 128, (333, x.shape[1]), generator=gen,
                      dtype=torch.int8)
    x, q, sa = x.cuda(), q.cuda(), sa.cuda()
    s = torch.tensor(0.05, device="cuda")
    got = lowp.w8a8_matmul(x, q.t(), s, sa)
    want = lowp._w8a8_plain(x, q.t(), s, sa)
    torch.cuda.synchronize()
    _check(torch.equal(got, want), "B8 differs on the rounding boundaries")

    bw, f32_peak, int8_peak = _peaks(card)
    m, k, n = shapes[0]
    q, s = (t.cuda() for t in _table(n, k, gen))
    x = torch.randn((m, k), generator=gen).cuda()
    sa = x.abs().max()
    sb, sa_c = torch.clamp_min(s, 1e-9), torch.clamp_min(sa, 1e-9)
    w_f32 = quant_ops.dequant_int8(q, s)        # yardstick's operand only
    flush = torch.empty(32 * 1024 * 1024, device="cuda")   # 128 MB
    table_t = q.t()
    rows = {
        "B7": dict(
            name="dequant_matmul", source="paddle_tpu_torch/csrc/quant_ops.cu",
            replaces="paddle_tpu/ops/quant_ops.py:231 (_dq_kernel)",
            ms=_time_ms(lambda: quant_ops._dequant_matmul_kernel(
                x, q, s.reshape(-1)), flush),
            plain_ms=_time_ms(lambda: quant_ops._dequant_matmul_plain(
                x, q, s.reshape(-1)), flush),
            library_ms=_time_ms(lambda: torch.matmul(x, w_f32.t()) * s,
                                flush),
            nbytes=m * k * 4 + n * k + 4 + m * n * 4,
            ops=2 * m * n * k, peak=f32_peak),
        "B8": dict(
            name="w8a8_matmul", source="paddle_tpu_torch/csrc/lowp.cu",
            replaces="paddle_tpu/ops/lowp.py:244 (_w8a8_kernel)",
            ms=_time_ms(lambda: lowp._w8a8_kernel(x, table_t, sb, sa_c),
                        flush),
            plain_ms=_time_ms(lambda: lowp._w8a8_plain(
                x, table_t, sb, sa_c), flush),
            library_ms=None,
            nbytes=m * k * 4 + n * k + 8 + m * n * 4,
            ops=2 * m * n * k, peak=int8_peak),
    }
    for key, row in rows.items():
        t_bytes = row.pop("nbytes") / bw * 1e3
        t_ops = row.pop("ops") / row.pop("peak") * 1e3
        row.update(route="cuda", max_abs_err=errs[key],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row["kernel_ms"] = row["ms"]
        print(json.dumps({"kernel": key, **row}), flush=True)
    return rows


def _tiny_values(model, seed):
    """numpy weights at 0.1 scale for the tiny parity model (its own
    0.02 init makes a tiny random GPT repeat one token)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    vals = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if len(shape) >= 2:
            v = rng.randn(*shape) * 0.1
        elif "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        vals[name] = v.astype(np.float32)
    return vals


def phase_slice():
    """Phase 3: int8 and w8a8 engines on cuda against the same engines
    on the CPU (the kernels' plain versions), same weights."""
    import numpy as np

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import GPTConfig
    from paddle_tpu_torch.nlp.transformers import GPTForPretraining
    from paddle_tpu_torch.serving import SlotEngine

    class RecordingEngine(SlotEngine):
        """Keeps the logits row behind each greedy pick."""

        def _pick(self, slot):
            self.rows.append(slot.next_logits.copy())
            return super()._pick(slot)

    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, dropout=0.0,
                    attn_dropout=0.0, use_parallel=False)
    models = {d: GPTForPretraining(cfg, device=d) for d in ("cuda", "cpu")}
    vals = _tiny_values(models["cpu"], 0)
    for m in models.values():
        weights.from_paddle_tpu_values(vals, m)
    prompts = [np.random.RandomState(s).randint(1, 97, (n,)).astype(
        np.int32) for s, n in ((3, 5), (50, 20), (9, 12))]
    for leg in (dict(quantize=True), dict(quantize=True, w8a8=True)):
        outs = {}
        for dev, model in models.items():
            eng = RecordingEngine(model, max_slots=2, block_size=8,
                                  prefill_chunk=8, device=dev, **leg)
            eng.rows = []
            eng.warmup()
            res = []
            for p in prompts:     # one at a time: rows stay in order
                fut = eng.submit(p, max_new_tokens=12, timeout=None)
                while True:
                    eng._admit()
                    if not eng.active:
                        break
                    eng._step()
                res.append(np.asarray(fut.result(60))[p.size:])
            outs[dev] = (res, eng)
        (cres, ceng), (pres, peng) = outs["cuda"], outs["cpu"]
        name = "w8a8" if leg.get("w8a8") else "int8"
        if leg.get("w8a8"):
            _check(ceng._act_frozen and peng._act_frozen,
                   "w8a8 activation scale did not freeze")
        # equal greedy tokens, except at a near-tie: where the two
        # devices' logits differ by at least half the CPU leg's top-2
        # margin, a flip is legitimate and the sequences part there
        worst = 0.0
        compared = total = i = 0
        for c, p in zip(cres, pres):
            stop = p.size
            for j in range(p.size):
                lc, lp = ceng.rows[i + j], peng.rows[i + j]
                dev = float(np.abs(lc - lp).max())
                if c[j] != p[j]:
                    top2 = np.sort(lp)[-2:]
                    _check(top2[1] - top2[0] <= 2 * dev,
                           f"{name}: cuda vs cpu token {j} differs at a "
                           f"margin of {top2[1] - top2[0]} with logits "
                           f"within {dev}: {c} vs {p}")
                    stop = j
                    break
                worst = max(worst, dev)
            compared, total, i = compared + stop, total + p.size, i + p.size
        _check(compared >= 0.75 * total,
               f"{name}: too many near-ties to compare ({compared}/{total})")
        # int8: the same f32 math summed in another order
        _check(name == "w8a8" or worst <= 1e-3,
               f"int8: cuda vs cpu logits differ by {worst}")
        print(json.dumps({"slice_vs_plain": name, "tokens_compared": compared,
                          "tokens": total, "max_logit_diff": worst}),
              flush=True)


def phase_full_width():
    """Phase 4: gpt2-small served in three legs; returns per-leg launch
    counts and the model."""
    import numpy as np
    import torch

    from paddle_tpu_torch.nlp.transformers import (
        GPTForPretraining, gpt_config,
    )
    from paddle_tpu_torch.ops import lowp, quant_ops
    from paddle_tpu_torch.serving import Server

    cfg = gpt_config("gpt2-small", dropout=0.0, attn_dropout=0.0,
                     use_parallel=False)
    model = GPTForPretraining(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    shared = rng.randint(1, cfg.vocab_size, (64,))
    prompts = []
    for i in range(16):
        n = int(rng.randint(32, 257))
        p = rng.randint(1, cfg.vocab_size, (n,))
        if i % 2 == 0:
            p[:64] = shared[:min(64, n)]
        prompts.append(p.astype(np.int32))
    max_new = 32
    legs = {"f32": {}, "int8": dict(quantize=True),
            "w8a8": dict(quantize=True, w8a8=True)}
    results, launches = {}, {}
    for name, kw in legs.items():
        srv = Server(model, max_slots=8, block_size=16, prefill_chunk=64,
                     device="cuda", **kw)
        quant_ops.dequant_matmul.launches = 0
        lowp.w8a8_matmul.launches = 0
        srv.start()                         # warmup: one step
        t0 = time.monotonic()
        futs = [srv.submit(p, max_new_tokens=max_new, timeout=600.0)
                for p in prompts]
        outs = [np.asarray(f.result(600.0)) for f in futs]
        wall = time.monotonic() - t0
        srv.shutdown(drain=True)
        b7 = quant_ops.dequant_matmul.launches
        b8 = lowp.w8a8_matmul.launches
        eng = srv.engine
        snap = srv.snapshot()
        steps = snap["counters"]["steps"]
        for p, o in zip(prompts, outs):
            _check(o.shape == (p.size + max_new,) and
                   np.array_equal(o[:p.size], p) and
                   o.min() >= 0 and o.max() < cfg.vocab_size,
                   f"{name}: malformed result")
        _check(snap["counters"]["completed"] == len(prompts) and
               snap["counters"].get("failed", 0) == 0,
               f"{name}: not every request completed: {snap['counters']}")
        if name == "f32":
            _check(b7 == 0 and b8 == 0, "f32 leg launched an int8 kernel")
        elif name == "int8":
            _check(b7 >= steps, f"int8: B7 ran {b7}x in {steps} steps")
        else:
            _check(b8 >= steps and b8 == steps,
                   f"w8a8: B8 ran {b8}x in {steps} steps")
            _check(eng._act_frozen, "w8a8 activation scale did not freeze")
        results[name] = [o[p.size:] for p, o in zip(prompts, outs)]
        launches[name] = {"B7": b7, "B8": b8}
        agree = None
        if name != "f32":
            same = sum(int(np.sum(a == b)) for a, b in
                       zip(results[name], results["f32"]))
            agree = same / (len(prompts) * max_new)
        step = snap["latency_s"]["step"]
        print(json.dumps({
            "leg": name, "requests": len(prompts), "max_new": max_new,
            "wall_s": wall, "tokens_per_s": len(prompts) * max_new / wall,
            "steps": steps, "step_p50_ms": step["p50"] * 1e3,
            "step_p99_ms": step["p99"] * 1e3,
            "kv_pool_bytes": eng.kv_pool_bytes,
            "prefix_hit_tokens": snap["counters"].get(
                "prefix_hit_tokens", 0),
            "launches": launches[name],
            "token_agreement_vs_f32": agree,
            "act_scale": float(eng._act_scale) if eng.w8a8 else None,
        }), flush=True)
    return launches, model


def phase_profile(model):
    """Phase 5: where a decode step's time goes. A w8a8 engine with all
    8 slots decoding takes 10 steps on the host clock (each ends in the
    logits' copy to the host), then 10 more under torch.profiler for the
    device's kernel time, the launches and the costliest kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import SlotEngine

    eng = SlotEngine(model, max_slots=8, block_size=16, prefill_chunk=64,
                     quantize=True, w8a8=True, device="cuda")
    eng.warmup()
    rng = np.random.RandomState(1)
    for _ in range(8):
        eng.submit(rng.randint(1, model.config.vocab_size, (64,)),
                   max_new_tokens=40, timeout=None)
    eng._admit()
    for _ in range(4):                  # the prefill step + 3 decode steps
        eng._step()
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng._step()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng._step()
        torch.cuda.synchronize()
    rows = prof.key_averages()

    def dev_us(row):
        return getattr(row, "self_device_time_total", None) \
            or getattr(row, "self_cuda_time_total", 0.0)

    kernels = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(r) for r in kernels) / 1e3 / n
    launches = sum(r.count for r in rows
                   if r.key.startswith("cudaLaunchKernel")) / n
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    _check(eng.metrics.get("failed") == 0, "profiled steps failed")
    print(json.dumps({
        "profile": "w8a8 decode step, 8 slots",
        "step_ms": host_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
        "launches_per_step": launches,
        "top_kernels_ms_per_step": {r.key[:60]: dev_us(r) / 1e3 / n
                                    for r in top},
    }), flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops import _build

    t_start = time.monotonic()
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    logs = _build.build_all()
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{src}: {line.strip()}", flush=True)

    t0 = time.monotonic()
    rows = phase_kernels(name)
    print(json.dumps({"phase_kernels_s": time.monotonic() - t0}),
          flush=True)
    t0 = time.monotonic()
    phase_slice()
    print(json.dumps({"phase_slice_s": time.monotonic() - t0}), flush=True)
    t0 = time.monotonic()
    launches, model = phase_full_width()
    print(json.dumps({"phase_full_width_s": time.monotonic() - t0}),
          flush=True)
    t0 = time.monotonic()
    phase_profile(model)
    print(json.dumps({"phase_profile_s": time.monotonic() - t0,
                      "total_s": time.monotonic() - t_start}), flush=True)

    for key in rows:
        rows[key]["launches"] = sum(leg[key] for leg in launches.values())
        _check(rows[key]["launches"] > 0, f"{key} never ran on the path")
    print(card)
    print(json.dumps({"kernels": [rows["B7"], rows["B8"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
