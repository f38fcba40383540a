"""The port's launcher (`python -m paddle_tpu_torch.distributed.launch`)
and `distributed.spawn`, on the CPU: the port's counterpart of
tests/test_launch.py without `test_eager_p2p_send_recv` (the p2p
mailbox waits with the parameter server's transport) and without the
reference's compiled-mesh steps (the port has no compiled step; its
hybrid step through the launcher stands for them).

- Two gloo ranks through the launcher run every eager collective and
  `gang.allreduce_host` across the two processes.
- A child that fails makes the watchdog tear down the pod at once and
  propagate its exit code (3).
- ``--elastic_retries 1`` relaunches a pod whose rank 1 is SIGKILLed
  in epoch 2, and `train_epoch_range` resumes each rank from its
  snapshot rather than from epoch 0 (as the reference's test).
- Two steps of the hybrid ERNIE at dp2 through the launcher equal the
  same steps under `torch_dist_workers.run_ranks` bit for bit (rtol 0):
  the launcher's env contract and rendezvous give the same world.
- `parse_args` / `_build_endpoints` keep the reference's arguments and
  endpoints; `spawn` calls the function for nprocs <= 1 and otherwise
  raises naming the launcher.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from paddle_tpu.distributed import launch as jlaunch

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import launch as tlaunch

from torch_dist_workers import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAYLOAD = os.path.join(REPO, "tests", "torch_gang_payload.py")


def _clean_env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("PADDLE_") or k.startswith("FLAGS_"):
            del env[k]
    env.pop("XLA_FLAGS", None)
    return env


def _launch(args, tmp_path, timeout=240):
    log_dir = str(tmp_path / "logs")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", log_dir, *args],
        cwd=REPO, env=_clean_env(), capture_output=True, text=True,
        timeout=timeout)
    logs = ""
    for rank in (0, 1):
        p = os.path.join(log_dir, f"workerlog.{rank}")
        if os.path.exists(p):
            logs += open(p).read()
    return proc, logs


def test_two_process_collective_through_launcher(tmp_path):
    proc, logs = _launch([PAYLOAD, "collective"], tmp_path)
    assert proc.returncode == 0, f"launcher failed:\n{logs}\n{proc.stderr}"
    assert "RANK 0 COLLECTIVE OK" in logs
    assert "RANK 1 COLLECTIVE OK" in logs


def test_watchdog_kills_pod_on_child_failure(tmp_path):
    start = time.time()
    proc, _ = _launch([PAYLOAD, "collective", "--crash-rank", "1"],
                      tmp_path)
    elapsed = time.time() - start
    assert proc.returncode == 3, (proc.returncode, proc.stderr)
    # the surviving rank sleeps 120 s; the watchdog must not wait for it
    assert elapsed < 60, f"watchdog too slow: {elapsed}s"
    assert "terminating the pod" in proc.stderr


def test_elastic_fault_injection_resumes_from_checkpoint(tmp_path):
    out = str(tmp_path)
    proc, logs = _launch(["--elastic_retries", "1", PAYLOAD, "elastic",
                          out], tmp_path)
    assert proc.returncode == 0, (proc.stderr, logs)
    assert open(os.path.join(out, "attempt_r1")).read() == "2"
    assert "elastic restart 1/1" in proc.stderr
    by_rank = {}
    for rank in (0, 1):
        lines = [ln.split() for ln in
                 open(os.path.join(out, f"epochs_r{rank}.log"))]
        epochs_by_attempt = {}
        for att, ep, _ in lines:
            epochs_by_attempt.setdefault(int(att), []).append(int(ep))
        by_rank[rank] = epochs_by_attempt
        all_epochs = sorted(e for eps in epochs_by_attempt.values()
                            for e in eps)
        assert sorted(set(all_epochs)) == list(range(6)), (rank, lines)
        assert len(all_epochs) <= 7, (rank, lines)
        if 2 in epochs_by_attempt and epochs_by_attempt.get(1):
            assert min(epochs_by_attempt[2]) >= \
                max(epochs_by_attempt[1]), (rank, lines)
    a2 = by_rank[1].get(2)
    assert a2 and min(a2) == 2, by_rank[1]


def test_hybrid_step_through_launcher_equals_run_ranks(tmp_path):
    out = str(tmp_path / "losses.json")
    proc, logs = _launch([PAYLOAD, "hybrid", out], tmp_path)
    assert proc.returncode == 0, (proc.stderr, logs)
    got = json.load(open(out))
    (tmp_path / "rr").mkdir()
    want = run_ranks(2, "torch_gang_payload:hybrid_step", (),
                     str(tmp_path / "rr"), timeout=120)
    assert want[0] == want[1]
    assert got == want[0], (got, want[0])
    assert all(v == v for v in got) and len(got) == 2


def test_parse_args_and_endpoints_match_the_reference():
    argv = ["--nnodes", "2", "--master", "10.0.0.1:7000", "--ips",
            "10.0.0.1,10.0.0.2", "--nproc_per_node", "2",
            "--elastic_retries", "3", "--gang_hang_secs", "5",
            "--min_np", "1", "train.py", "--lr", "0.1"]
    t, j = tlaunch.parse_args(argv), jlaunch.parse_args(argv)
    assert vars(t) == vars(j)
    assert tlaunch._build_endpoints(t) == jlaunch._build_endpoints(j)
    no_ips = tlaunch.parse_args(["--nnodes", "2", "--master",
                                 "h:7000", "--nproc_per_node", "2", "s"])
    assert tlaunch._build_endpoints(no_ips) == jlaunch._build_endpoints(
        jlaunch.parse_args(["--nnodes", "2", "--master", "h:7000",
                            "--nproc_per_node", "2", "s"]))
    single, world = tlaunch._build_endpoints(
        tlaunch.parse_args(["--nproc_per_node", "3", "s"]))
    assert world == 3 and len(set(single)) == 3
    assert all(e.startswith("127.0.0.1:") for e in single)


def test_spawn_contract():
    seen = []
    for n in (-1, 0, 1):
        tdist.spawn(seen.append, (n,), nprocs=n)
    assert seen == [-1, 0, 1]
    with pytest.raises(NotImplementedError, match="launch"):
        tdist.spawn(seen.append, (2,), nprocs=2)
    assert tdist.launch is tlaunch
