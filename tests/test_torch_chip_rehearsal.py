"""A CPU rehearsal of chip_smoke.py's phases 50-51 (ERNIE-1.0 pretraining
across ranks), run in a process of its own (it opens a world of one
gloo rank and spawns 2 and 4 more, as the script does on the card):

* phase 50 at narrow widths on the CPU: the hybrid engine against the
  single-card `Engine` at dropout 0, then the training leg with every
  step feature (no launches, profile or timing there);
* phase 51 at narrow widths: every leg against world size 1 passes as
  it is, and its checks catch each planted fault: the global norm's
  sums over the grid removed (the clipped mp2 leg's norms and losses
  leave world size 1's), and dropout masks at rank-local offsets (the
  dp2 leg's losses and parameters leave world size 1's).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

NARROW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              ffn_hidden_size=64, max_seq_len=16)
SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke as cs
from paddle_tpu_torch.distributed import parallel
parallel.init_parallel_env(backend="gloo", device="cpu",
                           init_method="file://{tmp}/store0", rank=0,
                           world_size=1)
rep50, l50 = cs.phase_ernie_hybrid("cpu", device="cpu", n=2,
                                   sizes=dict({narrow}, batches=(4,)))
rep51, l51, verdicts = cs.phase_ernie_multirank(
    "cpu", {tmp!r}, device="cpu", sizes=dict({narrow}, batch=8, seq=16),
    faults=(None, "clip_sum", "local_dropout"))
print("RESULT " + json.dumps({{"rep50": rep50, "rep51": rep51,
                              "verdicts": {{str(k): v for k, v in
                                            verdicts.items()}}}}))
"""


def test_phases_50_51_rehearse_and_catch_planted_faults(tmp_path):
    code = SCRIPT.format(repo=str(REPO), tmp=str(tmp_path),
                         narrow=repr(NARROW))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    rep50 = res["rep50"]
    assert rep50["check_max_rel_err"] <= 1e-3
    assert rep50["guard_bad_steps"] == 0
    legs = res["rep51"]
    assert set(legs) == {"dp2", "mp2.seqpar", "pp2", "sharding2.z2",
                         "features.dp2", "features.mp2", "comm.dp2",
                         "lowp.mp2", "pp2.hetero", "dp2.sharding2.z2",
                         "dp2.mp2.seqpar"}
    verdicts = res["verdicts"]
    assert verdicts["None"] is None
    assert verdicts["clip_sum"] and "features.mp2" in \
        verdicts["clip_sum"], verdicts["clip_sum"]
    assert verdicts["local_dropout"] and "dp2" in \
        verdicts["local_dropout"], verdicts["local_dropout"]
