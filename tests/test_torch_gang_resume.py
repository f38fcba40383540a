"""The port's gang resume on the CPU: a tier-1 counterpart of
tests/test_gang_slow.py on a tiny ERNIE (2 layers, hidden 32, dropout
0.1) under `Engine(mesh=)` at dp2 with ZeRO 2 over dp (AdamW, the
global-norm clip, dynamic loss scaling and the guard), launched as two
gloo ranks by `python -m paddle_tpu_torch.distributed.launch` with
``--elastic_retries 2`` (tests/torch_gang_payload.py ``ernie``: a
`GangWorker` beat a step, a `GangCheckpointManager` commit every 2
steps, 6 steps).

- A rank killed mid-collective: ``PADDLE_TPU_FAULTS`` crashes rank 1 on
  the first attempt inside step 5's gradient all-reduce
  (``dist.allreduce[grads]@5:crash``), after step 4 is committed. Rank 0
  leaves the collective with a typed retriable error within
  FLAGS_dist_timeout_s (5 s here); the supervisor tears the gang down
  and restarts it once; both ranks restore step 4 from the GANG marker,
  digest-checked, and every step's loss equals the clean run's bit for
  bit (the float's hex).
- A hung rank: rank 1 goes silent at step 3 of the first attempt; the
  supervisor's watermark (``--gang_hang_secs 2``) catches the stall,
  restarts the gang, and the losses again equal the clean run's bit for
  bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAYLOAD = os.path.join(REPO, "tests", "torch_gang_payload.py")
STEPS = 6
DEADLINE_S = 5.0


def _clean_env(extra):
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("PADDLE_") or k.startswith("FLAGS_"):
            del env[k]
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _launch(out, extra_env, *args):
    os.makedirs(out, exist_ok=True)
    log_dir = os.path.join(out, "logs")
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--elastic_retries", "2",
         "--gang_dir", os.path.join(out, "gang"),
         "--log_dir", log_dir, "--poll_interval", "0.05",
         *args, PAYLOAD, "ernie"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=_clean_env({"GANG_OUT": out, "GANG_STEPS": str(STEPS),
                        **extra_env}))
    logs = ""
    for rank in (0, 1):
        p = os.path.join(log_dir, f"workerlog.{rank}")
        if os.path.exists(p):
            logs += open(p).read()
    return r, logs


def _losses(out):
    got = {}
    with open(os.path.join(out, "losses.r0.log")) as f:
        for line in f:
            step, hexval = line.split()
            got[int(step)] = hexval  # the last execution of a step wins
    return got


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("clean"))
    r, logs = _launch(out, {"FLAGS_dist_timeout_s": "30"})
    assert r.returncode == 0, (r.stderr, logs[-4000:])
    got = _losses(out)
    assert sorted(got) == list(range(1, STEPS + 1))
    return got


def test_rank_killed_mid_collective_restarts_and_resumes_bitwise(
        clean, tmp_path):
    out = str(tmp_path / "kill")
    t0 = time.time()
    r, logs = _launch(out, {
        "FLAGS_dist_timeout_s": str(DEADLINE_S),
        "GANG_KILL_FAULTS": "dist.allreduce[grads]@5:crash"})
    assert r.returncode == 0, (r.stderr, logs[-4000:])
    assert time.time() - t0 < 120
    assert "terminating the pod" in r.stderr
    assert "elastic restart 1/2" in r.stderr
    assert "elastic restart 2/2" not in r.stderr
    # the survivor left the collective with a typed retriable error
    typed = open(os.path.join(out, "typed.r0.log")).read()
    assert ("PeerGoneError" in typed or "CollectiveTimeoutError" in typed) \
        and "retriable=True" in typed, typed
    # step 4 was the newest globally committed step; 5 never committed
    commits = os.listdir(os.path.join(out, "ckpt", "commits"))
    assert "s4.GANG.json" in commits and "s6.GANG.json" in commits
    got = _losses(out)
    assert got == clean
    # the first attempt ran steps 1-4 and the restart 5-6 once more
    lines = open(os.path.join(out, "losses.r0.log")).read().split()
    assert [int(s) for s in lines[::2]] == [1, 2, 3, 4, 5, 6]


def test_hung_rank_detected_by_watermark_and_gang_restarted(clean, tmp_path):
    out = str(tmp_path / "hang")
    r, logs = _launch(out, {"FLAGS_dist_timeout_s": "30",
                            "GANG_HANG_RANK": "1", "GANG_HANG_STEP": "3"},
                      "--gang_hang_secs", "2.0")
    assert r.returncode == 0, (r.stderr, logs[-4000:])
    assert "stalled" in r.stderr
    assert "elastic restart 1/2" in r.stderr
    assert _losses(out) == clean
