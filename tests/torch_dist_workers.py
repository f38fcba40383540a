"""Rank programs of the port's distributed tests
(tests/test_torch_distributed*.py), and the launcher that runs them.

`run_ranks` starts `nranks` processes (multiprocessing's spawn
context), each opening a gloo world on the CPU through a ``file://``
store under the caller's directory (so concurrent test workers never
race for a port), running one job of this module with its arguments,
and pickling what the job returns. The children import this module,
torch and the port only: never jax, never paddle_tpu. The parent
compares their results with the reference.
"""

from __future__ import annotations

import os
import pickle
import traceback

# the tiny GPT of __graft_entry__'s sweep, without its attention dropout
# (GPTConfig's default 0.1, which `_sweep_model` leaves on): the port
# draws each rank's masks from its own stream, so a factorization's
# masks are not the single device's (see tests/test_torch_distributed.py)
SWEEP_GPT = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
                 max_seq_len=32, dropout=0.0, attn_dropout=0.0)
SWEEP_LR = 0.05
SWEEP_STEPS = 2


def run_ranks(nranks, job, args, workdir, timeout=240):
    """Run ``job(rank, nranks, *args)`` on `nranks` gloo ranks; returns
    the list of their results (rank order). Raises with the failing
    ranks' tracebacks."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = os.path.join(workdir, "store")
    procs = []
    for rank in range(nranks):
        out = os.path.join(workdir, f"rank{rank}.pkl")
        p = ctx.Process(target=_entry,
                        args=(rank, nranks, store, job, args, out))
        p.start()
        procs.append(p)
    for p in procs:
        p.join(timeout)
    alive = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results, errors = [], []
    for rank in range(nranks):
        path = os.path.join(workdir, f"rank{rank}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {rank}: no result (exit "
                          f"{procs[rank].exitcode})")
            results.append(None)
            continue
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        if not ok:
            errors.append(f"rank {rank}:\n{value}")
        results.append(value)
    if alive or errors:
        raise RuntimeError(f"ranks timed out: {alive}\n" + "\n".join(errors))
    return results


def _entry(rank, nranks, store, job, args, out):
    import torch

    torch.set_num_threads(1)
    try:
        from paddle_tpu_torch.distributed import parallel

        parallel.init_parallel_env(backend="gloo", device="cpu",
                                   init_method=f"file://{store}",
                                   rank=rank, world_size=nranks)
        value = (True, globals()[job](rank, nranks, *args))
    except BaseException:      # reported to the parent, then re-raised
        value = (False, traceback.format_exc())
        with open(out, "wb") as f:
            pickle.dump(value, f)
        raise
    with open(out, "wb") as f:
        pickle.dump(value, f)


def _fleet(dp=1, mp=1, pp=1, sharding=1):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    strategy.sharding = sharding > 1
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _sweep_model(mp, seq_parallel):
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt

    cfg = tgpt.GPTConfig(**SWEEP_GPT, use_parallel=mp > 1,
                         sequence_parallel=seq_parallel)
    return (tgpt.GPTForPretraining(cfg, device="cpu"),
            tgpt.GPTPretrainingCriterion(cfg), cfg)


def sweep_engine(master, hcg, dp, mp, pp, sharding, zero, offload, sp,
                 opt_cls="SGD", lr=SWEEP_LR):
    """The engine a sweep config trains through (the hybrid engine
    under pp > 1, else the meshed `Engine`, whose loss takes a loss mask
    after the labels when given one), its model loaded with this rank's
    shards of `master`."""
    from paddle_tpu_torch import optimizer, weights
    from paddle_tpu_torch.distributed.hybrid import make_gpt_hybrid_engine
    from paddle_tpu_torch.engine import Engine

    model, crit, _ = _sweep_model(mp, sp)
    weights.shard_values(master, model, hcg)
    opt = getattr(optimizer, opt_cls)(learning_rate=lr,
                                      parameters=model.parameters())
    if pp > 1:
        eng = make_gpt_hybrid_engine(model, crit, opt, hcg,
                                     accumulate_steps=2 * pp,
                                     zero_stage=zero, offload=offload,
                                     device="cpu")
        return model, eng, lambda x, y: eng.train_batch(x, y)
    eng = Engine(model, opt, lambda out, *yy: crit(out, *yy), device="cpu",
                 seed=0, mesh=hcg.get_mesh(), batch_spec=("dp",),
                 zero_stage=zero,
                 sharding_axis="sharding" if sharding > 1 else None,
                 offload=offload)
    return model, eng, lambda x, *y: eng.train_batch((x,), y)


def sweep(rank, nranks, master, x, y, configs, zero_cases, masked):
    """Each sweep config's loss trajectory (rank 0's; every rank checks
    that its own equals it) and its parameters gathered back after the
    steps (rank 0's); the same for each `masked` config (name, dp, mp,
    sequence parallel, loss mask), whose loss takes the mask; then the
    ZeRO cases: one Adam step at mp2 x sharding4 for each stage,
    returning this rank's coordinates and its optimizer state slices."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed import all_gather_object
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    out, params = {}, {}
    runs = [(c[0], c[1:7] + (c[8],), ()) for c in configs]
    runs += [(name, (dp, mp, 1, 1, 0, False, sp), (mask,))
             for name, dp, mp, sp, mask in masked]
    for name, (dp, mp, pp, sh, zero, off, sp), extra in runs:
        hcg = _fleet(dp, mp, pp, sh)
        model, eng, step = sweep_engine(master, hcg, dp, mp, pp, sh, zero,
                                        off, sp)
        losses = [float(step(x, y, *extra)) for _ in range(SWEEP_STEPS)]
        every = all_gather_object([], losses)
        if any(v != every[0] for v in every):
            raise AssertionError(f"{name}: ranks disagree {every}")
        out[name] = losses
        eng.sync_to_layer()
        full = weights.gather_values(model, hcg)
        if rank == 0:
            params[name] = full
        set_hybrid_communicate_group(None)
    zero_out = {}
    for stage in zero_cases:
        hcg = _fleet(1, 2, 1, 4)
        _model, eng, step = sweep_engine(master, hcg, 1, 2, 1, 4, stage,
                                         stage == 3, False, opt_cls="Adam",
                                         lr=1e-2)
        step(x, y)
        coord = (hcg.get_model_parallel_rank(),
                 hcg.get_sharding_parallel_rank())
        states = {k: {kk: v.detach().cpu().numpy() for kk, v in st.items()}
                  for k, st in eng.state.opt_state.items()}
        zero_out[stage] = (coord, states, dict(eng._zero.dims))
        set_hybrid_communicate_group(None)
    return {"losses": out, "params": params, "zero": zero_out}


# -- TP layers and GPT at mp2 (tests/test_torch_distributed_tp.py) ----------


def _grads(params):
    return {k: p.grad.detach().numpy().copy() for k, p in params.items()
            if p.grad is not None}


def _marks(module):
    """{name: (split_axis, packs, sequence_parallel)} of its parameters."""
    out = {}
    for k, p in module.named_parameters():
        packs = getattr(p, "packed_heads", None)
        out[k] = (getattr(p, "split_axis", None), packs[0] if packs else 1,
                  bool(getattr(p, "sequence_parallel", False)))
    return out


def _run_layer(layer, x, ct, full, rank, degree):
    """Load `full` into `layer` (this rank's shards), run it on `x`
    (float inputs get gradients), backpropagate ``sum(out * ct)``."""
    import torch

    from paddle_tpu_torch import weights

    class _Hcg:
        def get_model_parallel_rank(self):
            return rank

        def get_model_parallel_world_size(self):
            return degree

    weights.shard_values(full, layer, _Hcg())
    xt = torch.tensor(x)
    if xt.is_floating_point():
        xt.requires_grad_(True)
    out = layer(xt)
    (out * torch.tensor(ct)).sum().backward()
    return {"out": out.detach().numpy(),
            "x_grad": None if xt.grad is None else xt.grad.numpy(),
            "grads": _grads(dict(layer.named_parameters())),
            "marks": _marks(layer)}


def tp(rank, nranks, cases, gpt_cfg, gpt_vals, ids, labels):
    """Each TP layer case, then the GPT forward and backward, at mp2
    without and with sequence parallelism. Inputs are the full arrays;
    under sequence parallelism a layer that takes the rank's part of
    the sequence gets it here."""
    import torch

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.distributed.sharding import (
        sync_sequence_parallel_grads,
    )
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt

    out = {}
    for sp in (False, True):
        hcg = _fleet(mp=2)
        r = hcg.get_model_parallel_rank()
        for name, kind, kw, full, x, ct in cases:
            if kw.get("sequence_parallel", False) != sp:
                continue
            if kind == "ce":
                layer = mpp.ParallelCrossEntropy(ignore_index=-100)
                logits, lbl = x
                n = logits.shape[-1] // 2
                lt = torch.tensor(logits[..., r * n:(r + 1) * n],
                                  requires_grad=True)
                loss = layer(lt, torch.tensor(lbl))
                (loss * torch.tensor(ct)).sum().backward()
                res = {"out": loss.detach().numpy(),
                       "x_grad": lt.grad.numpy()}
            else:
                layer = {"column": mpp.ColumnParallelLinear,
                         "row": mpp.RowParallelLinear,
                         "embedding": mpp.VocabParallelEmbedding}[kind](**kw)
                xin, cin = x, ct
                if sp and kind == "column":     # input: its sequence part
                    s = x.shape[1] // 2
                    xin = x[:, r * s:(r + 1) * s]
                if sp and kind == "row":        # output: its part
                    s = ct.shape[1] // 2
                    cin = ct[:, r * s:(r + 1) * s]
                res = _run_layer(layer, xin, cin, full, r, 2)
            out[(name, sp)] = res
        cfg = tgpt.GPTConfig(**gpt_cfg, use_parallel=True,
                             sequence_parallel=sp)
        model = tgpt.GPTForPretraining(cfg, device="cpu")
        weights.shard_values(gpt_vals, model, hcg)
        crit = tgpt.GPTPretrainingCriterion(cfg)
        logits = model(torch.tensor(ids))
        loss = crit(logits, torch.tensor(labels))
        loss.backward()
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        sync_sequence_parallel_grads(grads, params, hcg)
        out[("gpt", sp)] = {
            "logits": logits.detach().numpy(), "loss": float(loss),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "marks": _marks(model),
            "gathered": weights.gather_values(model, hcg)}
        set_hybrid_communicate_group(None)
    return out


# -- the collectives at world 4 (tests/test_torch_distributed_collectives.py)


def collectives(rank, nranks, w, b, x):
    """Every collective of `distributed.collective` on tensors made from
    the rank; returns what each left on this rank. Then the eager data
    parallel loop at dp = world: `fleet.distributed_model` (a
    `DataParallel`) of a Linear holding `w` / `b` on this rank's rows of
    `x`, ``scale_loss`` / ``backward`` / ``apply_collective_grads`` and
    one step of `fleet.distributed_optimizer(SGD(0.1))`."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C

    def base(shape=(2, 3)):
        return torch.arange(6, dtype=torch.float32).reshape(shape) + \
            10.0 * rank

    out = {}
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = base() + 1.0
        D.all_reduce(t, getattr(D.ReduceOp, op))
        out[f"all_reduce_{op}"] = t.numpy()
    out["all_gather"] = [t.numpy() for t in D.all_gather([], base())]
    out["all_gather_object"] = D.all_gather_object([], {"rank": rank})
    t = base()
    D.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    t = base()
    D.reduce(t, dst=1)
    out["reduce"] = t.numpy()
    t = torch.zeros(2, 3)
    D.reduce_scatter(t, [base() * (j + 1) for j in range(nranks)])
    out["reduce_scatter"] = t.numpy()
    t = torch.zeros(2, 3)
    D.scatter(t, [base() + 100.0 * j for j in range(nranks)]
              if rank == 3 else None, src=3)
    out["scatter"] = t.numpy()
    got = D.alltoall([base() + 100.0 * j for j in range(nranks)], [])
    out["alltoall"] = [t.numpy() for t in got]
    t = torch.zeros(2, 3)
    if rank % 2 == 0:
        D.send(base(), dst=rank + 1)
    else:
        D.recv(t, src=rank - 1)
    out["send_recv"] = t.numpy()
    D.barrier()
    D.wait(t)
    # a sub-group of the even ranks (every rank builds it)
    g = D.new_group([0, 2])
    t = base()
    D.all_reduce(t, group=g)
    out["subgroup"] = (g.rank, g.nranks, t.numpy())
    out["split"] = C.all_gather_cat(base(), 1, D.get_group()).numpy()
    out["staged"] = C.staged_bytes()

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.dataparallel import DataParallel
    from paddle_tpu_torch.distributed import fleet

    _fleet(dp=nranks)
    lin = nn.Linear(w.shape[0], w.shape[1])
    lin.set_state_dict({"weight": w, "bias": b})
    model = fleet.distributed_model(lin)
    assert isinstance(model, DataParallel)
    n = x.shape[0] // nranks
    y = model(torch.tensor(x[rank * n:(rank + 1) * n]))
    model.scale_loss((y * y).mean()).backward()
    model.apply_collective_grads()
    out["dp_grads"] = {k: p.grad.numpy().copy()
                       for k, p in lin.named_parameters()}
    opt = fleet.distributed_optimizer(
        optimizer.SGD(0.1, parameters=lin.parameters()))
    opt.step()
    out["dp_after"] = {k: p.detach().numpy().copy()
                       for k, p in lin.named_parameters()}
    return out
