"""The port's distributed training against the reference's
mesh-factorization sweep (``__graft_entry__.SWEEP_CONFIGS``).

Eight gloo ranks on the CPU (spawned once for the module, through
tests/torch_dist_workers.py, which imports no jax) run every config of
the sweep on the sweep's tiny GPT, batch and initial weights, through
the meshed `Engine` (pp 1), `make_gpt_hybrid_engine` (pp > 1) or, for
``pp2.hetero``, the `PipelineEngine` of a heterogeneous `PipelineLayer`
on its "hetero" schedule, and must reach the reference's single-device
trajectory within the config's own rtol. Configs of fewer than eight ranks run as several
grids of the same shape. Each config is also held to the reference's
own trajectory at attention dropout 0 (below) within 1e-5, and each
parameter's change over the steps, gathered back from the ranks, to the
reference's change within `DELTA_TOL` of the change's largest element:
a sum that a factorization misses (a sequence-parallel LayerNorm's
gradient over mp, the tied table's over pp) shows there, where the
losses barely move. A loss mask whose sums differ between the dp
slices (dp2, dp2.mp2 with sequence parallelism) must give the
reference's ratio over the global batch. Then ZeRO: one Adam step at
mp2 x sharding4 for each stage, every rank's optimizer-state slices
against the reference leaf rule's slice (``hybrid.py:_opt_leaf_spec``)
of the reference's state.

The reference's baseline trains with attention dropout 0.1 (GPTConfig's
``attn_dropout`` default, which ``_sweep_model`` leaves on), so its
trajectory depends on jax's random stream. The port draws its masks from
its own stream, per rank, so a factorization cannot repeat them; its
sweep runs with attention dropout 0. Against the baseline that costs
1.25e-4 of relative loss at step 2 (inside every config's rtol); against
the reference's own trajectory at attention dropout 0 the port at world
size 1 agrees within 1e-5.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import __graft_entry__ as graft  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.hybrid import HybridParallelEngine  # noqa: E402
from paddle_tpu.engine import Engine as JEngine, param_specs  # noqa: E402

from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import weights  # noqa: E402
from paddle_tpu_torch.engine import Engine  # noqa: E402
from paddle_tpu_torch.nlp.transformers import gpt as tgpt  # noqa: E402

from torch_dist_workers import SWEEP_GPT, run_ranks  # noqa: E402

CONFIGS = list(graft.SWEEP_CONFIGS)
ZERO_STAGES = (1, 2, 3)
# a parameter's change after the steps against the reference's, over
# the change's largest element: the sound factorizations read at most
# 1.25e-5 on the CPU; one that skips the sequence-parallel gradient sum
# over mp reads 0.78, the tied table's sum over pp 1.0, and masked dp
# slices averaged as equals 1.41
DELTA_TOL = 1e-3


def _batch():
    return graft._sweep_batch(types.SimpleNamespace(vocab_size=128))


def _mask():
    """A loss mask whose first half of the rows keeps ~90% of the
    tokens and whose second half ~25%: the dp slices weigh unequally."""
    _, y = _batch()
    rng = np.random.RandomState(11)
    keep = np.where(np.arange(len(y))[:, None] < len(y) // 2, 0.9, 0.25)
    return (rng.rand(*y.shape) < keep).astype(np.float32)


# (name, dp, mp, sequence parallel): the masked configs
MASKED = (("masked.dp2", 2, 1, False), ("masked.dp2.mp2.seqpar", 2, 2, True))


@pytest.fixture(scope="module")
def baseline():
    return graft.baseline_losses()


@pytest.fixture(scope="module")
def ranks(baseline, tmp_path_factory):
    _, master = baseline
    x, y = _batch()
    mask = _mask()
    res = run_ranks(8, "sweep", (master, x, y, CONFIGS, ZERO_STAGES,
                                 [m + (mask,) for m in MASKED]),
                    str(tmp_path_factory.mktemp("sweep")))
    return res


def _reference_no_attn_dropout(master, opt_factory, steps, mask=None):
    """The reference's single-device run of the sweep model with its
    attention dropout at 0 (its loss weighted by `mask` when given):
    (losses, engine)."""
    model, crit, cfg = graft._sweep_model(use_parallel=False)
    for layer in model.gpt.layers:
        layer.attn.attn_dropout = 0.0
    graft._set_state(model, master)
    eng = JEngine(model, opt_factory(model),
                  lambda out, *y: crit(out, *y))
    x, y = graft._sweep_batch(cfg)
    labels = (y,) if mask is None else (y, mask)
    losses = [float(eng.train_batch((x,), labels).item())
              for _ in range(steps)]
    return losses, eng


def _sgd(m):
    return paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=m.parameters())


@pytest.fixture(scope="module")
def reference(baseline):
    """The reference's trajectory at attention dropout 0 and its
    parameters after the steps, unmasked and under `_mask()`."""
    _, master = baseline
    out = {}
    for mask in (None, _mask()):
        losses, eng = _reference_no_attn_dropout(master, _sgd, 2, mask)
        out[mask is not None] = (losses, {
            k: np.asarray(v) for k, v in eng.state.params.items()})
    return out


def _delta_errs(got, want, master):
    """Each parameter's change from `master` in `got` against the
    change in `want`, relative to the largest element of the latter."""
    assert set(got) == set(want)
    errs = {}
    for k, w in want.items():
        dw = w - np.asarray(master[k])
        dg = np.asarray(got[k]) - np.asarray(master[k])
        errs[k] = float(np.max(np.abs(dg - dw)) /
                        max(float(np.max(np.abs(dw))), 1e-30))
    return errs


def test_port_at_world_one_matches_the_reference(baseline, reference):
    """The port's single-device run of the sweep model, `use_parallel`
    at its default (True, degree 1), within 1e-5 of the reference's at
    attention dropout 0, and within the sweep's rtol of its baseline."""
    ref, master = baseline
    want, _ = reference[False]
    cfg = tgpt.GPTConfig(**SWEEP_GPT)
    assert cfg.use_parallel
    model = tgpt.GPTForPretraining(cfg, device="cpu")
    weights.from_paddle_tpu_values(master, model)
    crit = tgpt.GPTPretrainingCriterion(cfg)
    eng = Engine(model, topt.SGD(0.05, parameters=model.parameters()),
                 lambda out, y: crit(out, y), device="cpu", seed=0)
    x, y = _batch()
    got = [float(eng.train_batch((x,), (y,))) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-4)


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_sweep_config_reaches_the_single_device_trajectory(cfg, baseline,
                                                           reference, ranks):
    """Within the config's rtol of the baseline, within 1e-5 of the
    reference's trajectory at attention dropout 0, and each parameter's
    change within `DELTA_TOL` of the reference's."""
    name, rtol = cfg[0], cfg[7]
    ref, master = baseline
    got = ranks[0]["losses"][name]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    assert err <= rtol, (name, got, ref, err)
    want, want_params = reference[False]
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    errs = _delta_errs(ranks[0]["params"][name], want_params, master)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= DELTA_TOL, (name, worst, errs[worst])


@pytest.mark.parametrize("cfg", MASKED, ids=[c[0] for c in MASKED])
def test_masked_loss_over_dp_is_the_global_batch_ratio(cfg, baseline,
                                                       reference, ranks):
    """A loss mask with unequal sums on the dp slices: the meshed
    engine's loss and update are the reference's over the global batch
    (sum(loss m) / sum(m) of all rows), not the mean of the slices'
    ratios."""
    name = cfg[0]
    _, master = baseline
    want, want_params = reference[True]
    got = ranks[0]["losses"][name]
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    errs = _delta_errs(ranks[0]["params"][name], want_params, master)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= DELTA_TOL, (name, worst, errs[worst])


def _leaf_rule_slice(ref_leaf, pspec, name, stage, mp_rank, sh_rank, split,
                     packs):
    """The reference leaf rule's slice of one reference state leaf at
    (mp rank, sharding rank): its spec from `_opt_leaf_spec`, the mp
    dimension cut as the port lays it out (`weights.shard_array`), the
    sharding dimension in four contiguous pieces."""
    stub = types.SimpleNamespace(
        zero_stage=stage, mesh=types.SimpleNamespace(shape={"sharding": 4}),
        _zero_warned=set())
    spec = tuple(HybridParallelEngine._opt_leaf_spec(
        stub, pspec, ref_leaf, name=name))
    a = np.asarray(ref_leaf)
    if split is not None and a.ndim:
        a = weights.shard_array(a, split, mp_rank, 2, packs)
    if "sharding" in spec:
        d = spec.index("sharding")
        n = a.shape[d] // 4
        a = np.take(a, range(sh_rank * n, (sh_rank + 1) * n), axis=d)
    return a


@pytest.mark.parametrize("stage", ZERO_STAGES)
def test_zero_state_slices_follow_the_reference_leaf_rule(stage, baseline,
                                                          ranks):
    _, master = baseline
    _, jeng = _reference_no_attn_dropout(
        master, lambda m: paddle.optimizer.Adam(
            learning_rate=1e-2, parameters=m.parameters()), 1)
    jmodel, _, _ = graft._sweep_model(use_parallel=True)
    specs = param_specs(jmodel)
    checked = 0
    for res in ranks:
        (mp_rank, sh_rank), states, dims = res["zero"][stage]
        assert set(states) == set(jeng.state.opt_state)
        for name, st in states.items():
            ref_st = jeng.state.opt_state[name]
            assert set(st) == set(ref_st), name
            spec = specs.get(name)
            split = None
            if spec is not None and "mp" in tuple(spec):
                split = tuple(spec).index("mp")
            packs = 3 if name.endswith(("qkv_proj.weight", "qkv_proj.bias")) \
                else 1
            for key, got in st.items():
                want = _leaf_rule_slice(
                    np.asarray(ref_st[key]),
                    tuple(spec) if spec is not None else None,
                    name, stage, mp_rank, sh_rank, split, packs)
                assert got.shape == want.shape, (name, key, got.shape,
                                                 want.shape)
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7,
                                           err_msg=f"{name}.{key}")
                checked += 1
    assert checked > 0


def test_rank_program_imports_no_jax():
    """The rank program the sweep spawns carries none of the reference."""
    import ast

    path = os.path.join(os.path.dirname(__file__), "torch_dist_workers.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax",
                                                        "paddle_tpu")]
    assert torch.__name__ == "torch"
