"""Multi-process launcher: `python -m paddle_tpu_torch.distributed.launch`
(counterpart of paddle_tpu/distributed/launch.py, with the same
arguments and env contract).

Ref parity: python/paddle/distributed/fleet/launch.py:396
(launch_collective) and fleet/launch_utils.py:453
(start_local_trainers) / :565 (watch_local_trainers). One process a
rank: each child reads the env contract below through
`parallel.init_parallel_env`, whose rendezvous is ``PADDLE_MASTER``
(rank 0's endpoint, a ``torch.distributed`` TCP store). Ranks on a card
of their own take NCCL; several ranks sharing one card ask
`init_parallel_env` for gloo, since NCCL refuses two ranks on one GPU.

The single-node path is gang-supervised (`gang.GangSupervisor`):
per-rank heartbeat files + step watermarks detect hangs (not just
exits), any rank dying or stalling tears down ALL ranks (SIGTERM ->
SIGKILL, reaped), and the gang restarts under exponential backoff with
flaky-rank quarantine - recovery is checkpoint-based via
`checkpoint.GangCheckpointManager`'s globally committed steps. The
multi-node (nnodes > 1) path keeps the classic per-node watchdog.

Env contract written for each child:
  PADDLE_TRAINER_ID         global rank of the process
  PADDLE_TRAINERS_NUM       world size (total processes)
  PADDLE_CURRENT_ENDPOINT   this process's endpoint host:port
  PADDLE_TRAINER_ENDPOINTS  comma list of all endpoints (rank order)
  PADDLE_MASTER             rendezvous address (= endpoint of rank 0)
  PADDLE_LOCAL_RANK         rank on this host (its card: cuda:<local>)
  PADDLE_GANG_DIR           gang heartbeat registry (supervised runs)
  PADDLE_GANG_SLOT          stable slot id across world re-formations
  PADDLE_GANG_ATTEMPT       1-based spawn generation
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

from .gang import GangSupervisor, _free_ports, terminate_all


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a distributed paddle_tpu_torch job "
                    "(one process a rank; torch.distributed bootstrap).")
    parser.add_argument("--nnodes", type=int, default=1,
                        help="number of hosts in the job")
    parser.add_argument("--node_rank", type=int,
                        default=int(os.environ.get("PADDLE_NODE_RANK", 0)),
                        help="rank of this host")
    parser.add_argument("--master", type=str, default=None,
                        help="rendezvous host:port (rank-0 host); "
                             "required when nnodes > 1")
    parser.add_argument("--ips", type=str, default=None,
                        help="comma list of host IPs, rank order (ref "
                             "fleet.launch --ips); defaults to the master "
                             "host for every node")
    parser.add_argument("--nproc_per_node", type=int, default=1,
                        help="processes (ranks) per host: one a card, or "
                             "several gloo ranks sharing one")
    parser.add_argument("--log_dir", type=str, default=None,
                        help="write per-rank workerlog.N files here")
    parser.add_argument("--elastic_retries", type=int, default=0,
                        help="restart the whole local pod up to N times "
                             "after a failure (ref fleet/elastic.py; "
                             "state recovery is checkpoint-based)")
    parser.add_argument("--gang_dir", type=str, default=None,
                        help="gang heartbeat registry directory (default: "
                             "a fresh tempdir); training scripts beat into "
                             "it via distributed.gang.GangWorker")
    parser.add_argument("--gang_hang_secs", type=float, default=None,
                        help="declare a beating-but-stalled rank hung "
                             "after this long (default: "
                             "FLAGS_gang_hang_secs; 0 disables)")
    parser.add_argument("--min_np", type=int, default=None,
                        help="smallest world the gang may re-form to when "
                             "ranks are quarantined (default: nproc)")
    parser.add_argument("--poll_interval", type=float, default=0.5)
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _build_endpoints(args):
    """Endpoint per global rank. Single-node: loopback + free ports."""
    world = args.nnodes * args.nproc_per_node
    if args.nnodes == 1:
        ports = _free_ports(args.nproc_per_node)
        return ["127.0.0.1:%d" % p for p in ports], world
    if not args.master:
        raise SystemExit("--master host:port is required when nnodes > 1")
    base = int(args.master.split(":")[1])
    if args.ips:
        hosts = [h.strip() for h in args.ips.split(",")]
        if len(hosts) != args.nnodes:
            raise SystemExit(
                f"--ips lists {len(hosts)} hosts but nnodes={args.nnodes}")
        # distinct hosts: each node reuses the same port block
        eps = [f"{hosts[node]}:{base + i}"
               for node in range(args.nnodes)
               for i in range(args.nproc_per_node)]
    else:
        # no --ips: all endpoints fabricated on the master host (same-host
        # testing); ports must then be globally unique to stay addressable
        host = args.master.split(":")[0]
        eps = [f"{host}:{base + node * args.nproc_per_node + i}"
               for node in range(args.nnodes)
               for i in range(args.nproc_per_node)]
    return eps, world


def start_local_trainers(args, endpoints, world, append_logs=False):
    """ref launch_utils.py:453 — one Popen per local rank with the env
    contract; stdout/stderr tee'd to workerlog.N when --log_dir given.
    append_logs: elastic retries must not truncate the failed attempt's
    traceback. (Multi-node path; single-node spawning lives in
    GangSupervisor._spawn_all.)"""
    procs = []
    logs = []
    master = args.master or endpoints[0]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for local in range(args.nproc_per_node):
        rank = args.node_rank * args.nproc_per_node + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_MASTER": master,
            "PADDLE_LOCAL_RANK": str(local),
        })
        cmd = [sys.executable, "-u", args.training_script] + \
            args.training_script_args
        if args.log_dir:
            f = open(os.path.join(args.log_dir, f"workerlog.{rank}"),
                     "a" if append_logs else "w")
            logs.append(f)
            p = subprocess.Popen(cmd, env=env, stdout=f,
                                 stderr=subprocess.STDOUT)
        else:
            p = subprocess.Popen(cmd, env=env)
        procs.append(p)
    return procs, logs


def _terminate_all(procs, grace=10.0):
    """Coordinated SIGTERM -> grace -> SIGKILL teardown, every exit
    reaped (gang.terminate_all is the one implementation)."""
    terminate_all(procs, grace=grace)


def watch_local_trainers(procs, poll_interval=0.5):
    """ref launch_utils.py:565 — poll children; any non-zero exit kills
    the whole local pod and propagates the code. (Multi-node path; the
    single-node watch loop with hang detection is GangSupervisor.run.)"""
    try:
        while True:
            alive = False
            for rank, p in enumerate(procs):
                ret = p.poll()
                if ret is None:
                    alive = True
                elif ret != 0:
                    sys.stderr.write(
                        f"[launch] rank {rank} (pid {p.pid}) exited with "
                        f"code {ret}; terminating the pod\n")
                    _terminate_all(procs)
                    return ret
            if not alive:
                return 0
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        _terminate_all(procs)
        return 130


def _supervisor(args, base_env=None):
    """The single-node path's `GangSupervisor` for parsed `args` (not yet
    spawned); `base_env` replaces this process's environment as the
    children's base."""
    gang_dir = args.gang_dir or tempfile.mkdtemp(prefix="paddle-gang-")
    cmd = [sys.executable, "-u", args.training_script] + \
        args.training_script_args
    return GangSupervisor(
        cmd, args.nproc_per_node, gang_dir=gang_dir,
        min_np=args.min_np or args.nproc_per_node,
        max_np=args.nproc_per_node,
        max_restarts=args.elastic_retries,
        hang_secs=args.gang_hang_secs,
        poll_interval=args.poll_interval, log_dir=args.log_dir,
        base_env=base_env)


def _launch_supervised(args):
    """Single-node path: the gang supervisor owns spawn, watch, hang
    detection, coordinated teardown, and backoff restarts."""
    from ..framework.errors import retry_with_backoff

    sup = _supervisor(args)

    def _sig(signum, frame):
        sup.terminate()
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _sig)
    # the bootstrap races the OS for ports and forks children; both fail
    # transiently under load (EADDRINUSE between probe and bind, EAGAIN
    # on fork) — retry with backoff instead of failing the job
    retry_with_backoff(sup._spawn_all, retries=3,
                       stat="launch_bootstrap_retries",
                       description="launch trainer spawn")
    return sup.run()


def _launch_legacy(args):
    """Multi-node per-node watchdog (no shared registry assumed)."""
    from ..framework.errors import retry_with_backoff

    attempts = 0
    while True:
        endpoints, world = retry_with_backoff(
            lambda: _build_endpoints(args), retries=3,
            stat="launch_bootstrap_retries",
            description="launch endpoint allocation")
        procs, logs = retry_with_backoff(
            lambda: start_local_trainers(args, endpoints, world,
                                         append_logs=(attempts > 0)),
            retries=3, stat="launch_bootstrap_retries",
            description="launch trainer spawn")

        def _sig(signum, frame, procs=procs):
            _terminate_all(procs)
            sys.exit(128 + signum)

        signal.signal(signal.SIGTERM, _sig)
        code = watch_local_trainers(procs, args.poll_interval)
        for f in logs:
            f.close()
        if code == 0 or attempts >= args.elastic_retries or code == 130:
            return code
        attempts += 1
        sys.stderr.write(
            f"[launch] elastic restart {attempts}/"
            f"{args.elastic_retries} after exit code {code}\n")


def launch(argv=None):
    args = parse_args(argv)
    if args.nnodes == 1:
        return _launch_supervised(args)
    return _launch_legacy(args)


if __name__ == "__main__":
    sys.exit(launch())
