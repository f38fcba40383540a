"""Rank programs of the port's gang, launcher and resume tests
(tests/test_torch_gang.py, test_torch_launch.py,
test_torch_gang_resume.py, test_torch_checkpoint_mesh.py).

Run by the launcher as a script (``python -m
paddle_tpu_torch.distributed.launch ... tests/torch_gang_payload.py
<mode> [args]``), each rank a gloo process on the CPU that reads the
launcher's env contract through `init_parallel_env`, or as jobs of
`torch_dist_workers.run_ranks` (the functions taking ``rank, nranks``).
It imports torch and the port only: never jax, never paddle_tpu.

Modes:
  collective [--crash-rank R]   the eager collectives across the ranks
                                (R exits 3 at once, the others sleep)
  hybrid OUT                    one hybrid ERNIE step (dp2), its losses
                                as JSON in OUT
  elastic OUT                   train_epoch_range; rank 1 is SIGKILLed
                                mid-run on the first attempt
  ernie                         tiny ERNIE under Engine(mesh=) at dp2
                                with ZeRO 2 over dp, a GangWorker beat a
                                step and a GangCheckpointManager commit
                                every 2 steps (env below)

`ernie`'s env (beside the launcher's PADDLE_*):
  GANG_OUT           output dir (losses, typed errors, checkpoints)
  GANG_STEPS         steps to complete
  GANG_KILL_FAULTS   a PADDLE_TPU_FAULTS value rank 1 runs under on the
                     first attempt (its crash is the planted death)
  GANG_HANG_RANK / GANG_HANG_STEP   go silent there (first attempt)
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the tiny ERNIE of the resume tests: 2 layers, hidden 32
ERNIE_GANG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  ffn_hidden_size=64, max_seq_len=16)
GANG_BATCH, GANG_SEQ, GANG_LR = 8, 16, 1e-2


def ernie_batch(step, batch=GANG_BATCH, seq=GANG_SEQ,
                vocab=ERNIE_GANG["vocab_size"]):
    """Step `step`'s global batch: random ids, MLM labels at 15% (else
    -100)."""
    import numpy as np

    rng = np.random.RandomState(31 * step + 7)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    labels = ids.copy()
    labels[rng.rand(batch, seq) > 0.15] = -100
    return ids, labels


def fleet_grid(dp=1, mp=1, sharding=1, device="cpu"):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": 1, "sharding_degree": sharding}
    strategy.sharding = sharding > 1
    fleet.init(is_collective=True, strategy=strategy, device=device)
    return fleet.get_hybrid_communicate_group()


def master_values(seed=5):
    """The tiny ERNIE's full weights from `seed` (``{name: array}``, the
    reference's names), built outside any hybrid group."""
    import torch

    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    try:
        full = ternie.ErnieForPretraining(
            ternie.ErnieConfig(**ERNIE_GANG, use_parallel=True),
            device="cpu", generator=torch.Generator().manual_seed(seed))
    finally:
        topology.set_hybrid_communicate_group(saved)
    return {k: v.detach().numpy() for k, v in full.state_dict().items()}


def ernie_mesh_engine(hcg, *, zero=0, axis=None, dropout=0.1, seed=5,
                      device="cpu", guard=True, values=None, sp=False):
    """(model, engine) of the tiny ERNIE under `Engine(mesh=)`: this
    rank's shards of `values` (default `master_values(seed)`), dropout
    `dropout`, sequence parallelism `sp`, AdamW with a global-norm clip,
    dynamic loss scaling and the guard (`guard`)."""
    from paddle_tpu_torch import clip, optimizer, weights
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    cfg = ternie.ErnieConfig(**ERNIE_GANG, dropout=dropout,
                             attn_dropout=dropout, use_parallel=True,
                             sequence_parallel=sp)
    model = ternie.ErnieForPretraining(cfg, device="cpu")
    weights.shard_values(master_values(seed) if values is None else values,
                         model, hcg)
    crit = ternie.ErniePretrainingCriterion(cfg)
    opt = optimizer.AdamW(learning_rate=GANG_LR,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=clip.ClipGradByGlobalNorm(1.0))
    # a grid of one rank has no DeviceMesh; the group stands for it
    mesh = hcg.get_mesh() if hcg.topology().world_size() > 1 else hcg
    eng = Engine(model, opt, lambda out, y: crit(out[0], out[1], y),
                 device=device, seed=0, mesh=mesh, batch_spec=("dp",),
                 zero_stage=zero, sharding_axis=axis,
                 loss_scale="dynamic" if guard else None,
                 anomaly_guard=guard)
    return model, eng


# -- run_ranks jobs (gloo ranks opened by torch_dist_workers) ----------------


def host_allreduce(rank, nranks, arrays, ops):
    """`gang.allreduce_host` of this rank's array under each op."""
    from paddle_tpu_torch.distributed import gang

    return {op: gang.allreduce_host(arrays[rank], op, deadline_s=30.0)
            for op in ops}


def host_barrier_missing(rank, nranks, deadline):
    """A barrier the last rank never enters (it stays alive past the
    deadline): (error class, retriable, seconds to raise) on the others."""
    from paddle_tpu_torch.distributed import gang

    if rank == nranks - 1:
        time.sleep(deadline + 2.0)
        return None
    t0 = time.monotonic()
    try:
        gang.barrier_host(deadline_s=deadline)
    except (gang.CollectiveTimeoutError, gang.PeerGoneError) as e:
        return type(e).__name__, e.retriable, time.monotonic() - t0
    return "passed", None, time.monotonic() - t0


def ernie_hybrid_engine(hcg, values, *, zero=0, offload=False, sp=False,
                        dropout=0.1):
    """(model, engine) of the tiny ERNIE through
    `make_ernie_hybrid_engine` (AdamW, ``accumulate_steps`` 2 pp under
    pp), this rank's shards of `values`."""
    from paddle_tpu_torch import optimizer, weights
    from paddle_tpu_torch.distributed.hybrid import make_ernie_hybrid_engine
    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    cfg = ternie.ErnieConfig(**ERNIE_GANG, dropout=dropout,
                             attn_dropout=dropout, use_parallel=True,
                             sequence_parallel=sp)
    model = ternie.ErnieForPretraining(cfg, device="cpu")
    weights.shard_values(values, model, hcg)
    opt = optimizer.AdamW(learning_rate=GANG_LR,
                          parameters=model.parameters(), weight_decay=0.01)
    pp = hcg.get_pipe_parallel_world_size()
    eng = make_ernie_hybrid_engine(
        model, ternie.ErniePretrainingCriterion(cfg), opt, hcg,
        accumulate_steps=2 * pp if pp > 1 else 1, zero_stage=zero,
        offload=offload, device="cpu", seed=0)
    return model, eng


def _grid(dp=1, mp=1, pp=1, sharding=1):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    set_hybrid_communicate_group(None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    strategy.sharding = sharding > 1
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _train(eng, steps, first=1):
    """Losses of steps `first`, ... of `eng` (the hybrid engine takes
    the ids and labels, the Engine their tuples)."""
    hybrid = hasattr(eng, "block_regex")
    return [float(eng.train_batch(*[a if hybrid else (a,)
                                    for a in ernie_batch(s)]))
            for s in range(first, first + steps)]


def mesh_ckpt(rank, nranks, master, other, tmp):
    """Two ranks: the step-0 checkpoints of the meshed Engine and of
    `save_hybrid_state` at mp2 with sequence parallelism, at dp2 with
    ZeRO 2 over dp (the Engine) and at sharding2 with ZeRO 2 (the hybrid
    engine), each rank under ``<tmp>/<name>.r<rank>``; then a dp2 ZeRO-2
    checkpoint after 2 steps, the uninterrupted 3rd step, and the 3rd
    step after restoring it into engines of `other`'s weights at world
    size 1, mp2 and dp2 with ZeRO 1 (with the digest of the restored
    engine's global payload)."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    os.makedirs(tmp, exist_ok=True)
    out = {}
    for name, grid, kw in (("mesh.mp2sp", dict(mp=2), dict(sp=True)),
                           ("mesh.dp2z2", dict(dp=2),
                            dict(zero=2, axis="dp"))):
        _, eng = ernie_mesh_engine(_grid(**grid), values=master, **kw)
        ckpt.save_train_state(os.path.join(tmp, f"{name}.r{rank}"), eng)
    for name, grid, kw in (("hybrid.mp2sp", dict(mp=2), dict(sp=True)),
                           ("hybrid.sh2z2", dict(sharding=2),
                            dict(zero=2))):
        _, eng = ernie_hybrid_engine(_grid(**grid), master, **kw)
        ckpt.save_hybrid_state(os.path.join(tmp, f"{name}.r{rank}"), eng)
    _, eng = ernie_mesh_engine(_grid(dp=2), values=master, zero=2,
                               axis="dp")
    out["first"] = _train(eng, 2)
    path = os.path.join(tmp, f"dp2z2.step2.r{rank}")
    ckpt.save_train_state(path, eng)
    out["uninterrupted"] = _train(eng, 1, first=3)[0]
    for name, grid, kw in (("w1", {}, {}), ("mp2", dict(mp=2), {}),
                           ("dp2.z1", dict(dp=2), dict(zero=1, axis="dp"))):
        _, eng = ernie_mesh_engine(_grid(**grid), values=other, **kw)
        ckpt.load_train_state(path, eng)
        state, _ = ckpt._engine_payload(eng)
        out[name] = {"step": eng.state.step, "digests":
                     ckpt.leaf_digests(state),
                     "loss": _train(eng, 1, first=3)[0]}
    out["manifest"] = {k: v["sha256"] for k, v in
                       ckpt.load_manifest(path).items()}
    return out


def hybrid_roundtrip(rank, nranks, master, other, tmp):
    """Four ranks: the hybrid ERNIE at mp2 x pp2 (ZeRO 1) and at pp2 x
    sharding2 under ZeRO 3 with offload: 2 steps, `save_hybrid_state`,
    the next step; a fresh engine of `other`'s weights restored with
    `load_hybrid_state` takes that step again. Then the ZeRO-3
    checkpoint restored at mp2 x pp2."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    out = {}
    grids = (("mp2.pp2", dict(mp=2, pp=2), {}),
             ("pp2.sh2.z3off", dict(pp=2, sharding=2),
              dict(zero=3, offload=True)))
    for name, grid, kw in grids:
        _, eng = ernie_hybrid_engine(_grid(**grid), master, **kw)
        _train(eng, 2)
        path = os.path.join(tmp, f"{name}.r{rank}")
        ckpt.save_hybrid_state(path, eng)
        nxt = _train(eng, 1, first=3)[0]
        _, fresh = ernie_hybrid_engine(_grid(**grid), other, **kw)
        ckpt.load_hybrid_state(path, fresh)
        out[name] = {"next": nxt, "resumed": _train(fresh, 1, first=3)[0],
                     "step": fresh.step,
                     "shards": sorted(fresh._zero.shards)}
    _, eng = ernie_hybrid_engine(_grid(mp=2, pp=2), other)
    ckpt.load_hybrid_state(os.path.join(tmp, f"pp2.sh2.z3off.r{rank}"),
                           eng)
    out["z3off.into.mp2.pp2"] = _train(eng, 1, first=3)[0]
    return out


def mesh_rollback(rank, nranks, values, x, y, tmp, faulted):
    """Two ranks: an MLP under `Engine(mesh=)` at dp2 with the guard
    (SGD 0.1, FLAGS_anomaly_max_bad_steps 2, checked every step), a
    checkpoint after step 2, 6 steps on one batch, under
    ``train.batch@3-4:nan`` when `faulted`: each step's (loss, engine
    step, guard counter), the rollbacks counted and the warnings."""
    import warnings

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.framework import faults, flags, monitor

    hcg = _grid(dp=2)
    model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    model.set_state_dict(values)
    eng = Engine(model, optimizer.SGD(0.1, parameters=model.parameters()),
                 lambda out, t: ((out - t) ** 2).mean(), device="cpu",
                 seed=0, mesh=hcg.get_mesh(), batch_spec=("dp",),
                 anomaly_guard=True)
    flags.set_flags({"FLAGS_anomaly_max_bad_steps": 2,
                     "FLAGS_anomaly_check_interval": 1})
    mgr = ckpt.CheckpointManager(os.path.join(tmp, f"r{rank}"))
    eng.attach_checkpoint_manager(mgr)
    before = monitor.stat_get("anomaly_rollbacks")
    rows = []
    ctx = faults.inject("train.batch@3-4:nan") if faulted else None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if ctx:
            ctx.__enter__()
        try:
            for step in range(6):
                loss = float(eng.train_batch((x,), (y,)))
                rows.append((loss, eng.state.step,
                             int(eng.anomaly_bad_steps)))
                if step == 1:
                    mgr.save_engine(2, eng)
        finally:
            if ctx:
                ctx.__exit__(None, None, None)
    return {"rows": rows,
            "rollbacks": monitor.stat_get("anomaly_rollbacks") - before,
            "warnings": [str(w.message) for w in seen
                         if "anomaly guard" in str(w.message)]}


def mesh_all(rank, nranks, master, other, mlp, x, y, tmp):
    """`mesh_ckpt`, then `mesh_rollback` clean and faulted, in one world
    of two ranks."""
    out = {"ckpt": mesh_ckpt(rank, nranks, master, other,
                             os.path.join(tmp, "ckpt"))}
    for name in ("clean", "faulted"):
        out[name] = mesh_rollback(rank, nranks, mlp, x, y,
                                  os.path.join(tmp, name),
                                  name == "faulted")
    return out


# -- launched modes ----------------------------------------------------------


def _collective(argv):
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import collective, gang
    from paddle_tpu_torch.distributed.parallel import init_parallel_env

    env = init_parallel_env(backend="gloo", device="cpu")
    if "--crash-rank" in argv:
        victim = int(argv[argv.index("--crash-rank") + 1])
        if env.rank == victim:
            os._exit(3)
        time.sleep(120)   # the watchdog must kill us well before this
        return 0
    assert env.world_size == 2, env.world_size
    t = torch.full((3,), float(env.rank + 1))
    collective.all_reduce(t)
    assert torch.equal(t, torch.full((3,), 3.0)), t
    b = torch.full((2,), float(env.rank))
    collective.broadcast(b, src=1)
    assert torch.equal(b, torch.ones(2)), b
    got = collective.all_gather([], torch.tensor([float(env.rank)]))
    assert [float(x) for x in got] == [0.0, 1.0], got
    collective.barrier()
    h = gang.allreduce_host(np.full(2, env.rank + 1.0), "sum")
    assert h.tolist() == [3.0, 3.0], h
    print(f"RANK {env.rank} COLLECTIVE OK", flush=True)
    return 0


def hybrid_step(rank, nranks, steps=2):
    """Two steps of the tiny ERNIE through the hybrid engine at dp2: the
    losses (every rank's alike)."""
    from paddle_tpu_torch.distributed.hybrid import make_ernie_hybrid_engine
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    from paddle_tpu_torch import optimizer, weights
    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    values = master_values(3)
    hcg = fleet_grid(dp=nranks)
    cfg = ternie.ErnieConfig(**ERNIE_GANG, dropout=0.1, attn_dropout=0.1,
                             use_parallel=True)
    model = ternie.ErnieForPretraining(cfg, device="cpu")
    weights.shard_values(values, model, hcg)
    opt = optimizer.AdamW(learning_rate=GANG_LR,
                          parameters=model.parameters())
    eng = make_ernie_hybrid_engine(model, ternie.ErniePretrainingCriterion(
        cfg), opt, hcg, device="cpu", seed=0)
    losses = []
    for step in range(steps):
        ids, labels = ernie_batch(step)
        losses.append(float(eng.train_batch(ids, labels)))
    set_hybrid_communicate_group(None)
    return losses


def _hybrid(argv):
    from paddle_tpu_torch.distributed.parallel import init_parallel_env

    import torch

    torch.set_num_threads(1)
    env = init_parallel_env(backend="gloo", device="cpu")
    losses = hybrid_step(env.rank, env.world_size)
    if env.rank == 0:
        with open(argv[0], "w") as f:
            json.dump(losses, f)
    return 0


def _elastic(argv):
    """ref tests/elastic_payload.py: rank 1 dies by SIGKILL in epoch 2
    of the first attempt; train_epoch_range resumes the relaunched pod
    from its snapshot."""
    import numpy as np
    import torch

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.engine import Engine

    out_dir = argv[0]
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    attempt_marker = os.path.join(out_dir, f"attempt_r{rank}")
    attempt = 1
    if os.path.exists(attempt_marker):
        attempt = int(open(attempt_marker).read()) + 1
    with open(attempt_marker, "w") as f:
        f.write(str(attempt))
    torch.manual_seed(7 + rank)
    model = nn.Linear(8, 4)
    opt = optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                             parameters=model.parameters())
    eng = Engine(model, opt, lambda out, y: ((out - y) ** 2).mean(),
                 device="cpu")
    rng = np.random.RandomState(rank)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    log = open(os.path.join(out_dir, f"epochs_r{rank}.log"), "a")
    for epoch in ckpt.train_epoch_range(6, os.path.join(out_dir,
                                                        f"ckpt_r{rank}"),
                                        eng, save_interval=1):
        if attempt == 1 and rank == 1 and epoch == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        loss = float(eng.train_batch((x,), (y,)))
        log.write(f"{attempt} {epoch} {loss:.6f}\n")
        log.flush()
    log.close()
    print(f"RANK {rank} DONE attempt={attempt}", flush=True)
    return 0


def _ernie(argv):
    """The gang trainer: see the module docstring."""
    out = os.environ["GANG_OUT"]
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    attempt = int(os.environ.get("PADDLE_GANG_ATTEMPT", "1"))
    if rank == 1 and attempt == 1 and os.environ.get("GANG_KILL_FAULTS"):
        os.environ["PADDLE_TPU_FAULTS"] = os.environ["GANG_KILL_FAULTS"]
    import torch

    from paddle_tpu_torch.distributed.checkpoint import (
        GangCheckpointManager,
    )
    from paddle_tpu_torch.distributed.gang import (
        CollectiveTimeoutError, GangWorker, PeerGoneError,
    )
    from paddle_tpu_torch.distributed.parallel import init_parallel_env

    torch.set_num_threads(1)
    env = init_parallel_env(backend="gloo", device="cpu")
    steps = int(os.environ.get("GANG_STEPS", "6"))
    hang_rank = int(os.environ.get("GANG_HANG_RANK", "-1"))
    hang_step = int(os.environ.get("GANG_HANG_STEP", "-1"))
    gw = GangWorker()
    hcg = fleet_grid(dp=env.world_size)
    _, eng = ernie_mesh_engine(hcg, zero=2, axis="dp")
    mgr = GangCheckpointManager(os.path.join(out, "ckpt"), env.rank,
                                env.world_size)
    if mgr.latest_committed_step() is not None:
        mgr.restore_engine(eng)
    lossf = open(os.path.join(out, f"losses.r{rank}.log"), "a")
    try:
        while eng.state.step < steps:
            step = eng.state.step + 1
            gw.beat(step=step)
            if rank == hang_rank and step == hang_step and attempt == 1:
                while True:
                    time.sleep(0.5)
            loss = float(eng.train_batch(*[(a,) for a in
                                           ernie_batch(step)]))
            lossf.write(f"{step} {loss.hex()}\n")
            lossf.flush()
            if step % 2 == 0:
                mgr.save_engine(step, eng)
    except (CollectiveTimeoutError, PeerGoneError) as e:
        with open(os.path.join(out, f"typed.r{rank}.log"), "a") as f:
            f.write(f"{type(e).__name__} retriable={e.retriable}: {e}\n")
        os._exit(13)
    lossf.close()
    # leave at once: the gloo world needs no teardown after the last step
    os._exit(0)


def main(argv):
    mode, rest = argv[0], argv[1:]
    return {"collective": _collective, "hybrid": _hybrid,
            "elastic": _elastic, "ernie": _ernie}[mode](rest)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
