"""The port's Megatron TP layers and GPT at mp2, with and without
sequence parallelism, against the reference's dense counterparts on the
same full weights (f32, rtol 1e-5, plus 1e-6 absolute for elements near
zero).

Two gloo ranks on the CPU (spawned once for the module through
tests/torch_dist_workers.py) load their shards of the full weights
(`weights.shard_values`), run each layer and the GPT forward and
backward, and return their outputs and gradients; here the pieces are
joined by each parameter's split marks and held against the reference's
`ColumnParallelLinear` / `RowParallelLinear` / `VocabParallelEmbedding`
/ `ParallelCrossEntropy` and GPT outside a mesh (dense, degree 1).
Sequence-parallel gradients of replicated parameters are summed over mp
as the engines sum them (`sharding.sync_sequence_parallel_grads`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import meta_parallel as jmp
from paddle_tpu.nlp.transformers import (
    GPTConfig, GPTForPretraining, GPTPretrainingCriterion,
)

from paddle_tpu_torch import weights
from paddle_tpu_torch.nlp.transformers import gpt as tgpt

from torch_dist_workers import run_ranks
from torch_parity import random_values

GPT_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=16, dropout=0.0, attn_dropout=0.0)
TOL = dict(rtol=1e-5, atol=1e-6)


def _cases():
    rng = np.random.RandomState(3)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    cases = []
    for sp in (False, True):
        cases.append((
            "column", "column",
            dict(in_features=16, out_features=24, gather_output=True,
                 sequence_parallel=sp),
            {"weight": arr(16, 24), "bias": arr(24)},
            arr(2, 4, 16), arr(2, 4, 24)))
        cases.append((
            "row", "row",
            dict(in_features=24, out_features=16, input_is_parallel=False,
                 sequence_parallel=sp),
            {"weight": arr(24, 16), "bias": arr(16)},
            arr(2, 4, 24), arr(2, 4, 16)))
    ids = rng.randint(0, 20, (2, 5))
    ids[0, :2] = (3, 17)                      # one id in each half
    cases.append(("embedding", "embedding",
                  dict(num_embeddings=20, embedding_dim=8),
                  {"weight": arr(20, 8)}, ids, arr(2, 5, 8)))
    labels = rng.randint(0, 20, (2, 5))
    labels[1, 1] = labels[0, 3] = -100
    cases.append(("ce", "ce", {}, {}, (arr(2, 5, 20), labels),
                  arr(2, 5, 1)))
    return cases


CASES = _cases()


def _gpt_inputs():
    jm = GPTForPretraining(GPTConfig(**GPT_CFG, use_parallel=False))
    from paddle_tpu.engine import state_values

    shapes = [(k, tuple(v.shape)) for k, v in state_values(jm).items()]
    vals = random_values(shapes, 5)
    rng = np.random.RandomState(9)
    ids = rng.randint(0, GPT_CFG["vocab_size"], (2, 8))
    labels = rng.randint(0, GPT_CFG["vocab_size"], (2, 8))
    labels[0, 2] = labels[1, 6] = -100
    return vals, ids, labels


@pytest.fixture(scope="module")
def gpt_inputs():
    return _gpt_inputs()


@pytest.fixture(scope="module")
def ranks(gpt_inputs, tmp_path_factory):
    vals, ids, labels = gpt_inputs
    return run_ranks(2, "tp", (CASES, GPT_CFG, vals, ids, labels),
                     str(tmp_path_factory.mktemp("tp")))


def _ref_layer(kind, kw, full, x, ct):
    """(out, x grad, {param: grad}) of the reference's layer outside a
    mesh."""
    kw = {k: v for k, v in kw.items() if k != "sequence_parallel"}
    if kind == "ce":
        logits, lbl = x
        lt = paddle.to_tensor(logits, stop_gradient=False)
        out = jmp.ParallelCrossEntropy(ignore_index=-100)(
            lt, paddle.to_tensor(lbl))
        (out * paddle.to_tensor(ct)).sum().backward()
        return np.asarray(out.numpy()), np.asarray(lt.grad.numpy()), {}
    cls = {"column": jmp.ColumnParallelLinear, "row": jmp.RowParallelLinear,
           "embedding": jmp.VocabParallelEmbedding}[kind]
    layer = cls(**kw)
    layer.set_state_dict({k: paddle.to_tensor(v) for k, v in full.items()})
    xt = paddle.to_tensor(x, stop_gradient=not np.issubdtype(
        x.dtype, np.floating))
    out = layer(xt)
    (out * paddle.to_tensor(ct)).sum().backward()
    xg = np.asarray(xt.grad.numpy()) if not xt.stop_gradient else None
    grads = {k: np.asarray(p.grad.numpy())
             for k, p in layer.named_parameters()}
    return np.asarray(out.numpy()), xg, grads


def _join_grads(per_rank, marks):
    """Full gradients from the ranks' pieces (a sequence-parallel
    replicated parameter's pieces are partial sums)."""
    out = {}
    for name, (split, packs, seq_par) in marks.items():
        pieces = [g[name] for g in per_rank]
        if split is not None:
            out[name] = weights.join_arrays(pieces, split, packs)
        elif seq_par:
            out[name] = sum(pieces)
        else:
            out[name] = pieces[0]
    return out


@pytest.mark.parametrize(
    "case", CASES,
    ids=[f"{c[0]}-sp{int(c[2].get('sequence_parallel', False))}"
         for c in CASES])
def test_tp_layer_matches_the_dense_reference(case, ranks):
    name, kind, kw, full, x, ct = case
    sp = kw.get("sequence_parallel", False)
    want_out, want_xg, want_g = _ref_layer(kind, kw, full, x, ct)
    res = [r[(name, sp)] for r in ranks]
    if kind == "ce":
        for r in res:
            np.testing.assert_allclose(r["out"], want_out, **TOL)
        got_xg = np.concatenate([r["x_grad"] for r in res], axis=-1)
        np.testing.assert_allclose(got_xg, want_xg, **TOL)
        return
    if sp and kind == "row":      # each rank holds its part of the sequence
        got_out = np.concatenate([r["out"] for r in res], axis=1)
    else:
        got_out = res[0]["out"]
        np.testing.assert_array_equal(res[1]["out"], got_out)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    if want_xg is not None:
        if sp and kind == "column":
            got_xg = np.concatenate([r["x_grad"] for r in res], axis=1)
        else:
            got_xg = res[0]["x_grad"]
        np.testing.assert_allclose(got_xg, want_xg, **TOL)
    got_g = _join_grads([r["grads"] for r in res], res[0]["marks"])
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **TOL)


def _ref_gpt(vals, ids, labels):
    jm = GPTForPretraining(GPTConfig(**GPT_CFG, use_parallel=False))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    crit = GPTPretrainingCriterion(GPTConfig(**GPT_CFG, use_parallel=False))
    logits = jm(paddle.to_tensor(ids))
    loss = crit(logits, paddle.to_tensor(labels))
    loss.backward()
    from paddle_tpu.engine import state_values

    grads = {}
    for k, p in jm.named_parameters():
        grads[k] = np.asarray(p.grad.numpy())
    assert set(grads) == set(state_values(jm))
    return np.asarray(logits.numpy()), float(loss.item()), grads


@pytest.mark.parametrize("sp", [False, True], ids=["mp2", "mp2-seqpar"])
def test_gpt_forward_and_gradients_match_the_dense_reference(
        sp, gpt_inputs, ranks):
    vals, ids, labels = gpt_inputs
    want_logits, want_loss, want_g = _ref_gpt(vals, ids, labels)
    res = [r[("gpt", sp)] for r in ranks]
    got_logits = np.concatenate([r["logits"] for r in res], axis=-1)
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    for r in res:
        assert abs(r["loss"] - want_loss) <= 1e-5 * abs(want_loss)
    got_g = {}
    for name, (split, packs, _sp) in res[0]["marks"].items():
        pieces = [r["grads"][name] for r in res]
        if split is None:
            np.testing.assert_allclose(pieces[1], pieces[0], **TOL)
            got_g[name] = pieces[0]
        else:
            got_g[name] = weights.join_arrays(pieces, split, packs)
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **TOL)
    # the sharded model gathers back into the weights it was given
    for r in res:
        assert set(r["gathered"]) == set(vals)
        for k, v in vals.items():
            np.testing.assert_array_equal(r["gathered"][k], v)


def test_packed_qkv_shard_holds_whole_heads():
    """At mp2 a rank's q / k / v columns are its heads of each of q, k
    and v: its product equals the dense product's heads [r nh/2, (r+1)
    nh/2) of each, and the pieces join back into the full weight."""
    rng = np.random.RandomState(0)
    h, nh = 32, 4
    hd = h // nh
    w = rng.randn(h, 3 * h).astype(np.float32)
    x = rng.randn(5, h).astype(np.float32)
    full = (x @ w).reshape(5, 3, nh, hd)
    pieces = []
    for r in range(2):
        wr = weights.shard_array(w, 1, r, 2, packs=3)
        pieces.append(wr)
        got = (x @ wr).reshape(5, 3, nh // 2, hd)
        np.testing.assert_allclose(
            got, full[:, :, r * nh // 2:(r + 1) * nh // 2], rtol=1e-5,
            atol=1e-5)
    np.testing.assert_array_equal(weights.join_arrays(pieces, 1, packs=3), w)


def test_default_gpt_config_builds_and_trains_at_degree_one():
    """`GPTConfig()`'s default ``use_parallel=True`` builds without a
    hybrid group (degree 1: the dense layers under the same names and
    shapes) and trains like ``use_parallel=False`` on the same
    weights."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.engine import Engine

    assert tgpt.GPTConfig().use_parallel
    vals, ids, labels = _gpt_inputs()
    losses = {}
    for par in (True, False):
        cfg = tgpt.GPTConfig(**GPT_CFG, use_parallel=par)
        model = tgpt.GPTForPretraining(cfg, device="cpu")
        weights.from_paddle_tpu_values(vals, model)
        crit = tgpt.GPTPretrainingCriterion(cfg)
        eng = Engine(model, topt.SGD(0.1, parameters=model.parameters()),
                     lambda out, y: crit(out, y), device="cpu", seed=0)
        losses[par] = [float(eng.train_batch(
            (torch.as_tensor(ids),), (torch.as_tensor(labels),)))
            for _ in range(3)]
        assert losses[par][-1] < losses[par][0]
    assert losses[True] == losses[False]


def test_waiting_distributed_features_raise_naming_the_roadmap_item():
    """What queue A item 4 still waits for raises NotImplementedError
    where it is reached, naming the item."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import hybrid
    from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp
    from paddle_tpu_torch.distributed.topology import (
        HybridCommunicateGroup, set_hybrid_communicate_group,
    )
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.framework.flags import set_flags

    cfg = tgpt.GPTConfig(**GPT_CFG)
    model = tgpt.GPTForPretraining(cfg, device="cpu")
    crit = tgpt.GPTPretrainingCriterion(cfg)
    set_hybrid_communicate_group(HybridCommunicateGroup())
    try:
        def engine(**kw):
            return Engine(model, topt.SGD(0.1, parameters=model.parameters()),
                          lambda out, y: crit(out, y), device="cpu",
                          mesh=object(), **kw)

        set_flags({"FLAGS_mp_overlap": True})
        try:
            with pytest.raises(NotImplementedError, match="item 4"):
                engine()
        finally:
            set_flags({"FLAGS_mp_overlap": False})
        # the step features no longer wait: the engine builds, and its
        # guard takes a rollback target (the meshed rollback is ported)
        eng = engine(comm_dtype="bfloat16", loss_scale="dynamic",
                     anomaly_guard=True)
        target = object()
        eng.attach_checkpoint_manager(target)
        assert eng._ckpt_manager is target
        assert callable(hybrid.make_ernie_hybrid_engine)
        assert callable(tmp.PipelineParallel)
    finally:
        set_hybrid_communicate_group(None)
