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


def hetero_layer(num_stages, master=None):
    """The sweep's GPT as a heterogeneous `PipelineLayer`, as the
    reference's ``__graft_entry__._run_hetero_config`` builds it: the
    embeddings (a shared layer), the blocks, the final norm and the
    tied logits (the shared layer's second use); its criterion; loaded
    with the sweep's `master` weights (GPT names) when given."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers import (
        PipelineLayer, SharedLayerDesc,
    )
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt
    from paddle_tpu_torch.nn import functional as F

    cfg = tgpt.GPTConfig(**SWEEP_GPT, use_parallel=False)
    crit = tgpt.GPTPretrainingCriterion(cfg)

    def tied_logits(base, x):
        return F.matmul(x, base.word_embeddings.weight, transpose_y=True)

    descs = [SharedLayerDesc("embed", tgpt.GPTEmbeddings, None, "weight",
                             cfg)]
    descs += [tgpt.GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)]
    descs.append(nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps))
    descs.append(SharedLayerDesc("embed", tgpt.GPTEmbeddings, tied_logits,
                                 "weight", cfg))
    pl = PipelineLayer(descs, num_stages=num_stages,
                       loss_fn=lambda lg, lb: crit(lg, lb))
    if master is not None:
        import torch

        values = hetero_names(master, cfg.num_layers)
        sd = pl.state_dict()
        assert set(values) == set(sd), set(values) ^ set(sd)
        with torch.no_grad():
            for k, t in sd.items():
                t.copy_(torch.as_tensor(values[k]))
    return pl


def hetero_names(values, num_layers, back=False):
    """GPT names -> the hetero layer's ``run_function.<n>.*`` names (or
    back)."""
    pairs = [("gpt.embeddings.", "run_function.0.")]
    pairs += [(f"gpt.layers.{i}.", f"run_function.{i + 1}.")
              for i in range(num_layers)]
    pairs.append(("gpt.final_norm.", f"run_function.{num_layers + 1}."))
    out = {}
    for k, v in values.items():
        for a, b in pairs:
            src, dst = (b, a) if back else (a, b)
            if k.startswith(src):
                out[dst + k[len(src):]] = v
                break
    return out


def hetero(rank, nranks, master, x, y, pp, steps, fallback_opt=None):
    """The sweep's pp2.hetero: the `PipelineEngine` of `hetero_layer`
    under pp (SGD 0.05, 2 pp micro-batches) with every warning an
    error; returns the losses, the schedule and the parameters gathered
    back (GPT names). With `fallback_opt` (an optimizer class name the
    hetero contract refuses) it returns the losses, the schedule and the
    warnings instead."""
    import warnings

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.pp_engine import PipelineEngine

    hcg = _fleet(pp=pp)
    pl = hetero_layer(pp, master)
    opt_cls = getattr(optimizer, fallback_opt or "SGD")
    opt = opt_cls(learning_rate=SWEEP_LR, parameters=pl.parameters())
    eng = PipelineEngine(pl, opt, hcg, accumulate_steps=2 * pp,
                         device="cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always" if fallback_opt else "error")
        losses = [float(eng.train_batch(x, y)) for _ in range(steps)]
    out = {"losses": _agree("hetero", losses), "schedule": eng.schedule,
           "warnings": [str(w.message) for w in seen]}
    eng.sync_to_layer()
    params = {k: v.detach().numpy().copy()
              for k, v in pl.state_dict().items()}
    out["params"] = hetero_names(params, SWEEP_GPT["num_layers"], back=True)
    return out


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
        if name.endswith("hetero"):
            res = hetero(rank, nranks, master, x, y, pp, SWEEP_STEPS)
            if res["schedule"] != "hetero":
                raise AssertionError(f"{name} ran {res['schedule']}")
            out[name] = res["losses"]
            if rank == 0:
                params[name] = res["params"]
            set_hybrid_communicate_group(None)
            continue
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


# -- ERNIE across ranks (tests/test_torch_ernie_parallel.py,
# test_torch_dropout_layout.py, test_torch_mesh_step_features.py) ----------

# a narrow ERNIE with every module of ERNIE-1.0; mp2 splits its heads,
# vocabulary, ffn and sequence in two
ERNIE_DIST = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  ffn_hidden_size=64, max_seq_len=16, type_vocab_size=4)
ERNIE_LR = 0.1


def _ernie(sp=False, dropout=0.0, attn_dropout=0.0, use_parallel=True):
    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    cfg = ternie.ErnieConfig(**ERNIE_DIST, dropout=dropout,
                             attn_dropout=attn_dropout,
                             use_parallel=use_parallel,
                             sequence_parallel=sp)
    return (ternie.ErnieForPretraining(cfg, device="cpu"),
            ternie.ErniePretrainingCriterion(cfg))


def ernie_engine(master, hcg, grid, *, hybrid=True, dropout=0.0,
                 opt_cls="SGD", lr=ERNIE_LR, grad_clip=None,
                 use_parallel=True, **features):
    """(model, step(ids, labels, *inputs)) of the ERNIE of `master` under
    `hcg`: `grid` = (dp, mp, pp, sharding, zero stage, sequence
    parallel); the hybrid engine (MLM loss, ``accumulate_steps`` 2 pp
    under pp) or the meshed `Engine` (MLM loss; extra inputs after the
    ids), `features` forwarded to the engine; ``use_parallel=False``
    builds the dense ERNIE (its fused LM-head loss on)."""
    from paddle_tpu_torch import optimizer, weights
    from paddle_tpu_torch.distributed.hybrid import make_ernie_hybrid_engine
    from paddle_tpu_torch.engine import Engine

    dp, mp, pp, sh, zero, sp = grid
    model, crit = _ernie(sp, dropout, dropout, use_parallel)
    weights.shard_values(master, model, hcg)
    kw = {} if grad_clip is None else {"grad_clip": grad_clip}
    opt = getattr(optimizer, opt_cls)(learning_rate=lr,
                                      parameters=model.parameters(), **kw)
    if hybrid:
        eng = make_ernie_hybrid_engine(
            model, crit, opt, hcg, accumulate_steps=2 * pp if pp > 1 else 1,
            zero_stage=zero, device="cpu", **features)
        return model, eng, lambda ids, lbl: eng.train_batch(ids, lbl)
    # a grid of one rank in a larger world has no DeviceMesh (torch's
    # takes a group of the grid's ranks); the engine reads the hybrid
    # group, so the group stands for it
    mesh = hcg.get_mesh() if dp * mp * pp * sh > 1 else hcg
    eng = Engine(model, opt, lambda out, y: crit(out[0], out[1], y),
                 device="cpu", seed=0, mesh=mesh,
                 batch_spec=("dp",), zero_stage=zero,
                 sharding_axis="sharding" if sh > 1 else None, **features)
    return model, eng, lambda ids, lbl, *inp: eng.train_batch(
        (ids, *inp), (lbl,))


def _agree(name, values):
    from paddle_tpu_torch.distributed import all_gather_object

    every = all_gather_object([], values)
    # by repr: a NaN loss equals itself there
    if any(repr(v) != repr(every[0]) for v in every):
        raise AssertionError(f"{name}: ranks disagree {every}")
    return values


def _run_grids(master, ids, labels, grids, steps, **kw):
    """Each named grid's losses (every rank's alike) and its parameters
    gathered back after the steps (a grid named "dense.*" trains the
    dense ERNIE)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    losses, params = {}, {}
    for name, grid, hybrid in grids:
        hcg = _fleet(grid[0], grid[1], grid[2], grid[3])
        model, eng, step = ernie_engine(master, hcg, grid, hybrid=hybrid,
                                        use_parallel=not name.startswith(
                                            "dense."), **kw)
        losses[name] = _agree(name, [float(step(ids, labels))
                                     for _ in range(steps)])
        eng.sync_to_layer()
        params[name] = weights.gather_values(model, hcg)
        set_hybrid_communicate_group(None)
    return losses, params


def _smm_recorder():
    """Wrap `ops.lowp.scaled_matmul` to record each call's operands and
    scales (the quantised codes follow from them)."""
    from paddle_tpu_torch.ops import lowp

    calls, real = [], lowp.scaled_matmul

    def rec(a, b, a_scale=None, b_scale=None, **kw):
        calls.append(tuple(t.detach().float().numpy().copy()
                           for t in (a, b, a_scale, b_scale)))
        return real(a, b, a_scale, b_scale, **kw)

    rec.launches = 0        # a CUDA wrapper counts on the name it calls
    return calls, rec


def ernie_parallel(rank, nranks, master, ids, labels, grids, steps,
                   lowp_grids, layer_case):
    """ERNIE's use_parallel through the hybrid engine at each of
    `grids` (dropout 0), then the meshed `Engine` under
    FLAGS_lowp_matmul int8 at each of `lowp_grids`, then one column- and
    one row-parallel product at mp2 under int8 with their B9 operands
    recorded."""
    import torch

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import lowp

    losses, params = _run_grids(master, ids, labels, grids, steps)
    set_flags({"FLAGS_lowp_matmul": "int8"})
    try:
        lowp_losses, _ = _run_grids(master, ids, labels, lowp_grids, steps)
        hcg = _fleet(mp=2)
        x, w_col, w_row = layer_case
        col = mpp.ColumnParallelLinear(w_col.shape[0], w_col.shape[1],
                                       gather_output=False, has_bias=False)
        row = mpp.RowParallelLinear(w_row.shape[0], w_row.shape[1],
                                    input_is_parallel=True, has_bias=False)
        weights.shard_values({"weight": w_col}, col, hcg)
        weights.shard_values({"weight": w_row}, row, hcg)
        calls, rec = _smm_recorder()
        real = lowp.scaled_matmul
        lowp.scaled_matmul = rec
        try:
            with torch.no_grad():
                h = col(torch.tensor(x))
                y = row(h)
        finally:
            lowp.scaled_matmul = real
        layers = {"calls": calls, "col_out": h.numpy(), "row_out": y.numpy()}
        set_hybrid_communicate_group(None)
    finally:
        set_flags({"FLAGS_lowp_matmul": "off"})
    return {"losses": losses, "params": params if rank == 0 else None,
            "lowp": lowp_losses, "layers": layers}


def dropout_layout(rank, nranks, master, ids, labels, grids, steps, p):
    """The grids at dropout and attention dropout `p`: losses and
    gathered parameters."""
    losses, params = _run_grids(master, ids, labels, grids, steps,
                                dropout=p)
    return {"losses": losses, "params": params if rank == 0 else None}


def _plant_inf(model, name, rank, at_rank, at_step, counter):
    """A hook on parameter `name` that makes its gradient inf on rank
    `at_rank` (every rank when None) at step `at_step` (counter[0]
    counts the backward passes)."""
    import torch

    p = dict(model.named_parameters())[name]

    def hook(g):
        counter[0] += 1
        if at_rank in (None, rank) and counter[0] == at_step:
            return torch.full_like(g, float("inf"))
        return g

    p.register_hook(hook)


def mesh_features(rank, nranks, master, ids, labels, mask_batches, grids,
                  steps, plant):
    """The step features across ranks. `grids`: (name, grid, hybrid,
    features) run for `steps` steps with FLAGS_record_grad_norm on:
    losses and the recorded global norms (features: grad_clip (a
    (class, arg) pair), comm_dtype, ...). `mask_batches`: ERNIE inputs
    with a float attention mask per step (NaN rows on one rank's slice
    at some step) run under dynamic loss scaling and under the guard at
    each of their grids: losses, the scale buffers and the guard's
    counter after every step. `plant`: (name, grid, parameter, step,
    only_last): an inf gradient at that step on the last rank's shard
    only (or on every rank), under dynamic scaling."""
    import torch

    from paddle_tpu_torch import clip as tclip
    from paddle_tpu_torch import engine as teng
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )
    from paddle_tpu_torch.framework.flags import set_flags

    out = {"norms": {}, "losses": {}, "scaled": {}, "planted": {},
           "comm_dtypes": {}}
    set_flags({"FLAGS_record_grad_norm": True})
    reduced = []
    real_ar = sharding.all_reduce

    def spy(t, *a, **k):
        reduced.append(str(t.dtype))
        return real_ar(t, *a, **k)

    try:
        for name, grid, hybrid, feats in grids:
            feats = dict(feats)
            clip = feats.pop("grad_clip", None)
            if clip is not None:
                clip = getattr(tclip, clip[0])(clip[1])
            hcg = _fleet(*grid[:4])
            model, eng, step = ernie_engine(master, hcg, grid,
                                            hybrid=hybrid, grad_clip=clip,
                                            **feats)
            bufs = eng.buffers if hybrid else eng.state.buffers
            del reduced[:]
            sharding.all_reduce = spy
            try:
                losses, norms = [], []
                for _ in range(steps):
                    losses.append(float(step(ids, labels)))
                    norms.append(float(bufs[teng.GRAD_NORM_KEY]))
            finally:
                sharding.all_reduce = real_ar
            out["losses"][name] = _agree(name, losses)
            out["norms"][name] = _agree(name + " norms", norms)
            out["comm_dtypes"][name] = sorted(set(reduced))
            set_hybrid_communicate_group(None)
    finally:
        set_flags({"FLAGS_record_grad_norm": False})
    for name, grid, feats in mask_batches[1]:
        hcg = _fleet(*grid[:4])
        model, eng, step = ernie_engine(master, hcg, grid, hybrid=False,
                                        **feats)
        bufs = eng.state.buffers
        rec = []
        for ids_k, lbl_k, inputs in mask_batches[0]:
            loss = float(step(ids_k, lbl_k, *inputs))
            rec.append([loss] + [float(bufs[k]) for k in (
                teng.LOSS_SCALE_KEY, teng.GOOD_STEPS_KEY,
                teng.BAD_STEPS_KEY, teng.ANOMALY_BAD_STEPS_KEY)
                if k in bufs])
        out["scaled"][name] = _agree(name, rec)
        set_hybrid_communicate_group(None)
    for name, grid, pname, at, only_last in plant:
        hcg = _fleet(*grid[:4])
        model, eng, step = ernie_engine(master, hcg, grid, hybrid=False,
                                        loss_scale=dict(
                                            init_loss_scaling=1024.0,
                                            decr_every_n_nan_or_inf=1,
                                            incr_every_n_steps=2))
        _plant_inf(model, pname, rank, nranks - 1 if only_last else None,
                   at, [0])
        rec = []
        for _ in range(steps + 1):
            loss = float(step(ids, labels))
            rec.append([loss] + [float(eng.state.buffers[k]) for k in (
                teng.LOSS_SCALE_KEY, teng.GOOD_STEPS_KEY,
                teng.BAD_STEPS_KEY)])
        out["planted"][name] = _agree(name, rec)
        set_hybrid_communicate_group(None)
    return out


def hetero_cases(rank, nranks, master, x, y, steps):
    """tests/test_torch_pipeline_hetero.py: pp2.hetero, the Lamb
    fallback, and `fleet.distributed_model` of the layer trained through
    its `PipelineParallel`."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    out = {"hetero": hetero(rank, nranks, master, x, y, 2, steps)}
    set_hybrid_communicate_group(None)
    out["fallback"] = hetero(rank, nranks, master, x, y, 2, steps, "Lamb")
    set_hybrid_communicate_group(None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": 4,
                                 "micro_batch_size": len(x) // 4}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    pl = hetero_layer(2, master)
    model = fleet.distributed_model(pl)
    opt = optimizer.SGD(learning_rate=SWEEP_LR, parameters=pl.parameters())
    losses = [float(model.train_batch((x, y), opt, device="cpu"))
              for _ in range(steps)]
    out["wrapped"] = {"type": type(model).__name__, "losses": losses}
    set_hybrid_communicate_group(None)
    return out
