#!/usr/bin/env python3
"""Before / after timings of the flash-attention dq kernel (B2) and the
LM-head loss kernels (B4-B6) of two checkouts of the port, on one card.

    python3 chip_ab.py PARENT_DIR

runs four processes in turn — PARENT_DIR, this checkout, this checkout,
PARENT_DIR (each imports `paddle_tpu_torch` from its tree and builds its
kernels there) — so that both versions are timed on the same card in
one call, and prints one JSON line per process: B2 at the ERNIE shape
([32, 12, 512, 64] bf16, dropout 0.1 and 0), B4, B5 and B6 at the
ERNIE head ([16384, 768] x [18000, 768] bf16), each as chip_smoke.py
times it (median of CUDA events, L2 flushed), and each kernel's largest
difference from the plain version on the same inputs (B2 absolute, B6
in bf16 ulps, also at a ragged head with every label valid). Needs one
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _smoke():
    """chip_smoke.py of this checkout (its timing and input helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from paddle_tpu_torch.ops import fused_loss as fl
    from paddle_tpu_torch.ops import fused_ops

    sm = _smoke()
    gen = torch.Generator().manual_seed(7)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    out = {"tree": str(tree), "card": sm._card_line()}

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
    del q, k, v, do, o, lse, delta, dq, dq_p

    cases = (("ernie", 16384, 768, 18000, 0.85, 0.02),
             ("ragged", 129, 768, 65, 0.0, 0.05))
    for label, n, hd, vocab, masked, w_std in cases:
        x, w, lbl, g = sm._lce_case(n, hd, vocab, masked, torch.bfloat16,
                                    gen, 1.0, w_std)
        lbl32 = lbl.to(torch.int32)
        nll, lse = fl._fwd_kernel(x, w, lbl)
        dw = fl._bwd_dw_kernel(x, w, lbl32, lse, g)
        dw_p = fl._bwd_plain(x, w, lbl, lse, g, 1024)[1]
        out[f"B6_ulps_{label}"] = sm._bf16_ulps(dw, dw_p)
        if label == "ernie":
            out["B4_ms"] = sm._time_ms(lambda: fl._fwd_kernel(x, w, lbl),
                                       flush)
            out["B5_ms"] = sm._time_ms(
                lambda: fl._bwd_dx_kernel(x, w, lbl32, lse, g), flush)
            out["B6_ms"] = sm._time_ms(
                lambda: fl._bwd_dw_kernel(x, w, lbl32, lse, g), flush)
        del x, w, dw, dw_p
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: python3 chip_ab.py PARENT_DIR (needs a CUDA card)",
              file=sys.stderr)
        sys.exit(2)
    for tree in (sys.argv[1], ROOT, ROOT, sys.argv[1]):
        subprocess.run([sys.executable, __file__, "--one", str(tree)],
                       check=True)


if __name__ == "__main__":
    main()
