#!/usr/bin/env python3
"""Before / after timings of the flash-attention dq kernel (B2), the
LM-head loss kernels (B4-B6), the serving head's int8 kernels (B7, B8),
the scaled int8 / fp8 matmul (B9), the fused conv (B10) and three
end-to-end paths (the cost of the runtime's always-on spans) of two
checkouts of the port, on one card.

    python3 chip_ab.py PARENT_DIR [GROUP ...]

runs four processes in turn — PARENT_DIR, this checkout, this checkout,
PARENT_DIR (each imports `paddle_tpu_torch` from its tree and builds its
kernels there) — so that both versions are timed on the same card in
one call, and prints one JSON line per process. GROUPs (default: all)
choose what each process times, in this order:

- B2: at the ERNIE shape ([32, 12, 512, 64] bf16, dropout 0.1 and 0);
- B4-B6: B4, B5 and B6 at the ERNIE head ([16384, 768] x [18000, 768]
  bf16), with B5's and B6's largest difference in bf16 ulps from the
  plain version, also at a ragged head with every label valid;
- B7, B8: at the serving head (x [8, 768] f32, the gpt2-small int8
  table [50304, 768] frozen per tensor; B8 reads it in place as its
  transpose, as the engine passes it), each checked against the tree's
  plain version, B7 within rtol = atol = 1e-5 and B8 bit for bit; also
  the kernel's own device time from torch.profiler (`*_kernel_us`),
  which leaves out the few us that a pair of events adds to any launch;
- B9: int8 and fp8 at each of the nine distinct calls of one ERNIE-1.0
  low-precision train step (`B9_STEP_CALLS`), int8 checked bit for bit
  and fp8 within chip_smoke.py's `_fp8_tol` against the tree's plain
  version, summed over the step's 69 calls;
- B10: at every conv of one ResNet-50 training step at b128 (bf16,
  recorded from the tree's own model), checked within one bf16 ulp of
  the plain version, summed over the step's 114 launches in all and by
  class;
- spans: three paths through the tree's engines, each repeated
  `SPAN_REPEATS` times: chip_smoke.py phase 4's int8 leg (gpt2-small,
  16 prompts x 32 new tokens through `Server`, tokens/s), phase 5's
  decode step (the w8a8 engine, 8 slots decoding, host ms a step over 10
  steps) and phase 9's ERNIE-1.0 step (b32 x s512 bf16, the fused loss,
  AdamW; p50 of 10 steps after 2 warm-up steps, each ending in a
  synchronise), with the cyclic collector's passes over those steps
  and the same steps with the collector off; then, where the tree has
  observe/, the host us of one phase span, one RecordEvent and one
  decode-step signature. Only the tree's public engine APIs are used,
  so a parent without the observe/ spans runs the same code.

Every time is taken as chip_smoke.py takes it (median of CUDA events, L2
flushed before each launch). With B4-B6 chosen, a fifth process then
loads both checkouts' fused-loss libraries and times B6 of each on the
same inputs in turns (the parent's `fused_lce` entry must take this
checkout's arguments), so that a difference between the processes above
is told from one between the kernels. Needs one CUDA card; exits 2
without one.
"""

from __future__ import annotations

import ctypes
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _smoke():
    """chip_smoke.py of this checkout (its timing and input helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GROUPS = ("B2", "B4-B6", "B7", "B8", "B9", "B10", "spans")
SPAN_REPEATS = 3


def one(tree, groups):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    sm = _smoke()
    gen = torch.Generator().manual_seed(7)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    out = {"tree": str(tree), "card": sm._card_line()}
    if "B2" in groups:
        out.update(b2_ernie(sm, gen, flush))
    if "B4-B6" in groups:
        out.update(b4_b6_head(sm, gen, flush))
    out.update(serving_head(sm, gen, flush, groups))
    if "B9" in groups:
        out.update(b9_step(sm, gen, flush))
    if "B10" in groups:
        out.update(b10_step(sm, gen, flush))
    if "spans" in groups:
        del flush
        torch.cuda.empty_cache()
        out.update(spans(sm))
    print(json.dumps(out), flush=True)


def b2_ernie(sm, gen, flush):
    """B2 at the ERNIE shape, dropout 0.1 and 0, and its largest absolute
    difference from the plain version."""
    import torch

    from paddle_tpu_torch.ops import fused_ops

    out = {}
    b, h, s, d = 32, 12, 512, 64
    seed = torch.tensor(20260101, device="cuda")
    q, k, v = sm._packed_qkv(b, h, s, d, torch.bfloat16, gen)
    do = torch.randn((b, s, h, d), generator=gen).to(
        torch.bfloat16).cuda().transpose(1, 2)
    o, lse = fused_ops._flash_fwd_kernel(q, k, v, seed, 0.125, False, 0.1)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = torch.empty((b, h, s, d), dtype=torch.bfloat16, device="cuda")

    def b2(p):
        fused_ops._launch_pass(1, q, k, v, do, dq, None, None, lse, delta,
                               seed, 0.125, False, p)

    b2(0.1)
    to3 = fused_ops._to3
    dq_p = fused_ops._flash_bwd_plain(to3(q), to3(k), to3(v), to3(o),
                                      to3(lse), to3(do), seed, 0.125, False,
                                      0.1)[0]
    out["B2_max_abs_err"] = (to3(dq).float() -
                             dq_p.float()).abs().max().item()
    out["B2_ms"] = sm._time_ms(lambda: b2(0.1), flush)
    out["B2_dropout0_ms"] = sm._time_ms(lambda: b2(0.0), flush)
    return out


def b4_b6_head(sm, gen, flush):
    """B4-B6 at the ERNIE head; B5's and B6's bf16 ulps against the plain
    version there and at a ragged head."""
    import torch

    from paddle_tpu_torch.ops import fused_loss as fl

    out = {}
    cases = (("ernie", 16384, 768, 18000, 0.85, 0.02),
             ("ragged", 129, 768, 65, 0.0, 0.05))
    for label, n, hd, vocab, masked, w_std in cases:
        x, w, lbl, g = sm._lce_case(n, hd, vocab, masked, torch.bfloat16,
                                    gen, 1.0, w_std)
        lbl32 = lbl.to(torch.int32)
        nll, lse = fl._fwd_kernel(x, w, lbl)
        dw = fl._bwd_dw_kernel(x, w, lbl32, lse, g)
        dw_p = fl._bwd_plain(x, w, lbl, lse, g, 1024)[1]
        out[f"B6_ulps_{label}"] = sm._ulps(dw, dw_p)
        dx = fl._bwd_dx_kernel(x, w, lbl32, lse, g)
        out[f"B5_ulps_{label}"] = sm._ulps(
            dx, fl._bwd_plain(x, w, lbl, lse, g, 1024)[0])
        if label == "ernie":
            out["B4_ms"] = sm._time_ms(lambda: fl._fwd_kernel(x, w, lbl),
                                       flush)
            out["B5_ms"] = sm._time_ms(
                lambda: fl._bwd_dx_kernel(x, w, lbl32, lse, g), flush)
            out["B6_ms"] = sm._time_ms(
                lambda: fl._bwd_dw_kernel(x, w, lbl32, lse, g), flush)
        del x, w, dx, dw, dw_p
    return out


def _kernel_us(fn, flush, names, n=20):
    """Median device time (us) of the kernels whose names hold one of
    `names`, over `n` launches of `fn` under torch.profiler (each after
    the L2 flush): the kernel alone, without the events' launch gap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    us = sorted(getattr(e, "device_time_total", None) or e.cuda_time_total
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in names))
    return us[len(us) // 2] if us else None


def serving_head(sm, gen, flush, groups):
    """B7 and B8 at the serving head, each checked against the tree's
    plain version (B7 within 1e-5, B8 bit for bit), timed by events and
    by the profiler's kernel time."""
    import torch

    from paddle_tpu_torch.ops import lowp, quant_ops

    out = {}
    if "B7" not in groups and "B8" not in groups:
        return out
    m, k, n = 8, 768, 50304
    q, s = (t.cuda() for t in sm._table(n, k, gen))
    x = torch.randn((m, k), generator=gen).cuda()
    if "B7" in groups:
        sc = s.reshape(-1)
        got = quant_ops._dequant_matmul_kernel(x, q, sc)
        want = quant_ops._dequant_matmul_plain(x, q, sc)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        out["B7_max_abs_err"] = (got - want).abs().max().item()
        out["B7_ms"] = sm._time_ms(
            lambda: quant_ops._dequant_matmul_kernel(x, q, sc), flush)
        out["B7_kernel_us"] = _kernel_us(
            lambda: quant_ops._dequant_matmul_kernel(x, q, sc), flush,
            ("dq_stream", "dequant_matmul"))
    if "B8" in groups:
        sa = x.abs().max()
        got = lowp._w8a8_kernel(x, q.t(), s, sa)
        sm._check(torch.equal(got, lowp._w8a8_plain(x, q.t(), s, sa)),
                  "B8 differs from its plain version")
        out["B8_ms"] = sm._time_ms(lambda: lowp._w8a8_kernel(x, q.t(), s, sa),
                                   flush)
        out["B8_kernel_us"] = _kernel_us(
            lambda: lowp._w8a8_kernel(x, q.t(), s, sa), flush,
            ("w8a8_stream", "w8a8_matmul"))
    return out


# B9's distinct calls in one ERNIE-1.0 low-precision train step at b32 x
# s512, as chip_smoke.py's phase 14 records them: (m, k, n, a dtype, a's
# row stride, b dtype, b layout) -> calls a step (69: the 51 Linears and
# the loss's 18 vocab chunks)
B9_STEP_CALLS = {
    (32, 768, 2, "float32", 768, "float32", "weight"): 1,
    (32, 768, 768, "float32", 393216, "float32", "weight"): 1,
    (16384, 768, 592, "bfloat16", 768, "bfloat16", "chunk"): 1,
    (16384, 768, 768, "bfloat16", 768, "float32", "weight"): 12,
    (16384, 768, 768, "float32", 768, "float32", "weight"): 1,
    (16384, 768, 1024, "bfloat16", 768, "bfloat16", "chunk"): 17,
    (16384, 768, 2304, "float32", 768, "float32", "weight"): 12,
    (16384, 768, 3072, "float32", 768, "float32", "weight"): 12,
    (16384, 3072, 768, "float32", 3072, "float32", "weight"): 12,
}


def b9_step(sm, gen, flush):
    """B9 in int8 and fp8 at each of B9_STEP_CALLS, summed over the step;
    int8 bit for bit and fp8 within `_fp8_tol` of the plain version."""
    import torch

    from paddle_tpu_torch.ops import lowp

    out = {}
    for q in ("int8", "fp8"):
        total, per_call, worst = 0.0, {}, 0.0
        for key, per_step in sorted(B9_STEP_CALLS.items()):
            a, b = sm._b9_operands(*key, gen)
            sa, sb = lowp.amax_of(a), lowp.amax_of(b)
            got = lowp._smm_kernel(a, b, sa, sb, q)
            want = lowp._smm_plain(a, b, sa, sb, q)
            if q == "int8":
                sm._check(torch.equal(got, want),
                          f"B9 int8 differs from its plain version at {key}")
            else:
                tol = sm._fp8_tol(a, b, sa, sb)
                worst = max(worst, float(((got.double() - want.double())
                                          .abs() / (tol + 1e-30)).max()))
                sm._check(worst <= 1.0, f"B9 fp8 beyond _fp8_tol at {key}")
            ms = sm._time_ms(lambda: lowp._smm_kernel(a, b, sa, sb, q),
                             flush, n=20)
            per_call["x".join(map(str, key[:3])) + f" {key[3]}/{key[5]}"
                     f" {key[6]}"] = ms
            total += per_step * ms
            del a, b, got, want
        out[f"B9_{q}_step_ms"] = total
        out[f"B9_{q}_ms"] = per_call
        if q == "fp8":
            out["B9_fp8_err_of_tol"] = worst
    return out


def b10_step(sm, gen, flush):
    """B10 summed over one ResNet-50 training step's launches, in all and
    by `chip_smoke._conv_class`; the largest bf16 ulp against the plain
    version."""
    import torch

    from paddle_tpu_torch.ops import fused_conv

    train_calls, _ = sm._record_resnet_convs()
    total, by_class, ulps = 0.0, {}, 0.0
    for key, per_step in sorted(train_calls.items()):
        _x, _w, plan, xp, wk, kw = sm._conv_operands(key, torch.bfloat16,
                                                     gen)
        got = fused_conv._conv_kernel(xp, wk, plan, **kw)[0]
        ulps = max(ulps, sm._ulps(
            got, fused_conv._conv_plain(xp, wk, plan, **kw)[0]))
        ms = sm._time_ms(lambda: fused_conv._conv_kernel(xp, wk, plan, **kw),
                         flush, n=20, spin=sm.AUTOGRAD_SPIN)
        total += per_step * ms
        cls = sm._conv_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + per_step * ms
    return {"B10_step_ms": total, "B10_step_launches":
            sum(train_calls.values()), "B10_by_class_ms": by_class,
            "B10_max_ulps": ulps}


def spans(sm):
    """Phase 4's int8 tokens/s, phase 5's decode-step host ms and phase
    9's ERNIE-1.0 p50, `SPAN_REPEATS` times each, through the tree's
    engines (chip_smoke.py's settings and inputs)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nlp.transformers import (
        ErnieConfig, GPTForPretraining, gpt_config,
    )
    from paddle_tpu_torch.serving import Server

    cfg = gpt_config("gpt2-small", dropout=0.0, attn_dropout=0.0,
                     use_parallel=False)
    model = GPTForPretraining(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    prompts = sm._serving_prompts(cfg.vocab_size)
    n_new = sm.SERVING_MAX_NEW
    out = {"int8_tokens_per_s": [], "decode_step_host_ms": [],
           "ernie_step_ms_p50": []}
    for _ in range(SPAN_REPEATS):
        srv = Server(model, device="cuda", quantize=True,
                     **sm.SERVING).start()
        t0 = time.monotonic()
        futs = [srv.submit(p, max_new_tokens=n_new, timeout=600.0)
                for p in prompts]
        for f in futs:
            f.result(600.0)
        wall = time.monotonic() - t0
        srv.shutdown(drain=True)
        out["int8_tokens_per_s"].append(len(prompts) * n_new / wall)
    eng = sm._decode_engine(model, quantize=True, w8a8=True)
    for _ in range(SPAN_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            eng._step()
        out["decode_step_host_ms"].append(
            (time.perf_counter() - t0) * 1e3 / 10)
    del eng, srv, model
    torch.cuda.empty_cache()
    ecfg = ErnieConfig(**sm.ERNIE)
    ids, labels = sm._ernie_batch(ecfg.vocab_size, sm.ERNIE_BATCH,
                                  sm.ERNIE_SEQ)
    eng = sm._ernie_engine(ecfg, "cuda", 0, 0, 1e-4)

    def step():
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            return eng.train_batch(ids, labels)

    def timed_steps():
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    # the cyclic collector's passes over the timed steps, and the same
    # steps with it off: a host-side difference between the trees that
    # the collector explains shows as a gap between the two
    collections = {0: 0, 1: 0, 2: 0}

    def on_gc(phase, info):
        if phase == "start":
            collections[info["generation"]] += 1

    out["ernie_step_ms_p50_gc_off"] = []
    for _ in range(SPAN_REPEATS):
        for _ in range(2):
            step()
        gc.callbacks.append(on_gc)
        try:
            out["ernie_step_ms_p50"].append(timed_steps())
        finally:
            gc.callbacks.remove(on_gc)
        gc.collect()
        gc.disable()
        try:
            out["ernie_step_ms_p50_gc_off"].append(timed_steps())
        finally:
            gc.enable()
    out["ernie_gc_collections"] = collections
    del eng
    out.update(span_cost_us())
    torch.cuda.empty_cache()
    return out


def span_cost_us(n=20000):
    """Host us of one `observe.phase`, one `profiler.RecordEvent` and
    one decode-step `signature_of`, each the median of 5 runs of `n`,
    where the tree has them (a parent without observe/ gives none)."""
    import numpy as np

    from paddle_tpu_torch import observe

    if not hasattr(observe, "phase"):
        return {}
    from paddle_tpu_torch import profiler

    tok, pos, bt = (np.zeros(s, np.int32) for s in ((8, 64), (8,), (8, 64)))
    cases = {"phase": lambda: observe.phase("span-cost"),
             "record_event": lambda: profiler.RecordEvent("span-cost")}
    out = {}
    for key, make in cases.items():
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                with make():
                    pass
            runs.append((time.perf_counter() - t0) / n * 1e6)
        out[f"{key}_us"] = float(np.median(runs))
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            observe.signature_of(tok, pos, bt)
        runs.append((time.perf_counter() - t0) / n * 1e6)
    out["signature_of_us"] = float(np.median(runs))
    return {"span_cost_us": out}


def b6_in_turns(parent, rounds=8):
    """B6 at the ERNIE head through this checkout's wrapper, launching
    the parent's library and this one's in turns (ABBA order), in one
    process on one set of inputs: each round's median and both outputs
    compared bit for bit."""
    sys.path.insert(0, str(ROOT))
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_loss as fl

    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent).resolve() / "paddle_tpu_torch" / "ops" /
        "_build.py")
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    libs = {"parent": ctypes.CDLL(str(parent_build._compile("fused_loss")[0])),
            "change": _build.load("fused_loss")}
    sm = _smoke()
    gen = torch.Generator().manual_seed(7)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    x, w, lbl, g = sm._lce_case(16384, 768, 18000, 0.85, torch.bfloat16,
                                gen, 1.0, 0.02)
    lbl32 = lbl.to(torch.int32)
    _nll, lse = fl._fwd_kernel(x, w, lbl)
    dws, times = {}, {key: [] for key in libs}
    for r in range(rounds):
        for key in (("parent", "change") if r % 2 == 0 else
                    ("change", "parent")):
            _build._libs["fused_loss"] = libs[key]
            dws[key] = fl._bwd_dw_kernel(x, w, lbl32, lse, g)
            times[key].append(sm._time_ms(
                lambda: fl._bwd_dw_kernel(x, w, lbl32, lse, g), flush))
    _build._libs["fused_loss"] = libs["change"]
    print(json.dumps({"B6_in_turns_ms": times, "card": sm._card_line(),
                      "median_ms": {k: sorted(v)[len(v) // 2]
                                    for k, v in times.items()},
                      "equal": torch.equal(dws["parent"], dws["change"])}),
          flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3:])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--b6-turns":
        b6_in_turns(sys.argv[2])
        return
    import torch

    groups = sys.argv[2:] or list(GROUPS)
    if len(sys.argv) < 2 or not torch.cuda.is_available() or \
            not set(groups) <= set(GROUPS):
        print("usage: python3 chip_ab.py PARENT_DIR [GROUP ...] (GROUPs of "
              f"{', '.join(GROUPS)}; needs a CUDA card)", file=sys.stderr)
        sys.exit(2)
    for tree in (sys.argv[1], ROOT, ROOT, sys.argv[1]):
        subprocess.run([sys.executable, __file__, "--one", str(tree),
                        *groups], check=True)
    if "B4-B6" in groups:
        subprocess.run([sys.executable, __file__, "--b6-turns", sys.argv[1]],
                       check=True)


if __name__ == "__main__":
    main()
