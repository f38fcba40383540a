"""ERNIE's ``use_parallel=True`` and ``make_ernie_hybrid_engine`` against
the reference's single-device ERNIE pretraining.

Two gloo ranks on the CPU (spawned once for the module through
tests/torch_dist_workers.py, which imports no jax) train a narrow ERNIE
(every module of ERNIE-1.0: the Megatron layout of q / k / v, out_proj,
fc1, fc2, the vocab-split word table and tied MLM head, the pooler and
NSP head) from the same numpy weights as the reference, at dropout 0,
with MLM labels whose non-ignored rows are spread unevenly over the
batch (so a dp slice or a micro-batch that averaged its own rows would
miss the global batch's ratio):

* the hybrid engine at world size 1, dp2, mp2, mp2 with sequence
  parallelism and pp2 (4 micro-batches), and the dense ERNIE (fused
  LM-head loss) through the meshed `Engine` at dp2, whose slices
  averaged their own MLM means before (fault C8): 3 SGD steps within
  rtol 1e-5 of the reference's `Engine` and each parameter's change,
  gathered back from the ranks (`weights.gather_values`), within
  `DELTA_TOL` of the reference's change's largest element (a gradient
  sum a factorization misses, such as the MLM transform's LayerNorm over
  mp under sequence parallelism, shows there);
* ``FLAGS_lowp_matmul=int8`` through the meshed `Engine` at mp2 (with
  and without sequence parallelism): within 1e-5 of the port at world
  size 1 and within B9's stated rtol 2e-3 (tests/test_torch_lowp_training.py)
  of the reference's single-device low-precision losses (the fused
  LM-head loss off on both sides, as ``use_parallel`` has it);
* one column- and one row-parallel product at mp2 under int8: the
  scales B9 takes are the single rank's, bit for bit, and so are its
  int8 codes of every shard; the column-parallel outputs are the slices
  of the single rank's output, bit for bit (int32 sums are exact).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.engine import Engine as JEngine, state_values  # noqa: E402
from paddle_tpu.framework.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.nlp.transformers import (  # noqa: E402
    ErnieConfig, ErnieForPretraining, ErniePretrainingCriterion,
)

from paddle_tpu_torch import weights  # noqa: E402
from paddle_tpu_torch.nlp.transformers import ernie as ternie  # noqa: E402
from paddle_tpu_torch.ops import lowp as tlowp  # noqa: E402

from torch_dist_workers import ERNIE_DIST, ERNIE_LR, run_ranks  # noqa: E402
from torch_parity import random_values  # noqa: E402

STEPS = 3
# a parameter's change against the reference's, over the change's
# largest element (tests/test_torch_distributed.py's rule)
DELTA_TOL = 1e-3
LOWP_RTOL = 2e-3
# (name, (dp, mp, pp, sharding, zero stage, sequence parallel), hybrid)
GRIDS = [("w1", (1, 1, 1, 1, 0, False), True),
         ("dp2", (2, 1, 1, 1, 0, False), True),
         ("mp2", (1, 2, 1, 1, 0, False), True),
         ("mp2.seqpar", (1, 2, 1, 1, 0, True), True),
         ("pp2", (1, 1, 2, 1, 0, False), True),
         # the dense ERNIE (fused LM-head loss) through the meshed Engine:
         # its MLM mean over the global batch's rows (fault C8)
         ("dense.dp2", (2, 1, 1, 1, 0, False), False)]
LOWP_GRIDS = [("lowp.w1", (1, 1, 1, 1, 0, False), False),
              ("lowp.mp2", (1, 2, 1, 1, 0, False), False),
              ("lowp.mp2.seqpar", (1, 2, 1, 1, 0, True), False)]


def _config(**kw):
    return ErnieConfig(**ERNIE_DIST, dropout=0.0, attn_dropout=0.0,
                       use_parallel=False, **kw)


def _master():
    jm = ErnieForPretraining(_config())
    shapes = [(k, tuple(v.shape)) for k, v in state_values(jm).items()]
    return random_values(shapes, seed=3)


def _batch():
    """8 x 8 ids; MLM labels kept on ~60% of the first four rows and
    ~20% of the last four (-100 elsewhere)."""
    rng = np.random.RandomState(5)
    ids = rng.randint(0, ERNIE_DIST["vocab_size"], (8, 8)).astype(np.int32)
    keep = np.where(np.arange(8)[:, None] < 4, 0.6, 0.2)
    labels = np.where(rng.rand(8, 8) < keep, ids, -100).astype(np.int32)
    return ids, labels


def reference_run(master, steps, ids, labels, lowp="off", **engine_kw):
    """The reference's single-device ERNIE pretraining (MLM loss): the
    losses and the parameters after the steps."""
    jset_flags({"FLAGS_lowp_matmul": lowp,
                "FLAGS_use_fused_lm_loss": lowp == "off"})
    try:
        jm = ErnieForPretraining(_config())
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in master.items()})
        crit = ErniePretrainingCriterion()
        eng = JEngine(jm, paddle.optimizer.SGD(learning_rate=ERNIE_LR,
                                               parameters=jm.parameters()),
                      lambda out, y: crit(out[0], out[1], y), **engine_kw)
        losses = [float(eng.train_batch((ids,), (labels,)).item())
                  for _ in range(steps)]
        return losses, {k: np.asarray(v) for k, v in eng.state.params.items()}
    finally:
        jset_flags({"FLAGS_lowp_matmul": "off",
                    "FLAGS_use_fused_lm_loss": True})


def delta_errs(got, want, master):
    """Each parameter's change from `master` in `got` against the change
    in `want`, relative to the largest element of the latter."""
    assert set(got) == set(want)
    errs = {}
    for k, w in want.items():
        dw = w - np.asarray(master[k])
        dg = np.asarray(got[k]) - np.asarray(master[k])
        errs[k] = float(np.max(np.abs(dg - dw)) /
                        max(float(np.max(np.abs(dw))), 1e-30))
    return errs


def _layer_case():
    rng = np.random.RandomState(9)
    return (rng.randn(2, 5, 16).astype(np.float32),
            (rng.randn(16, 24) * 0.3).astype(np.float32),
            (rng.randn(24, 16) * 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def master():
    return _master()


@pytest.fixture(scope="module")
def ranks(master, tmp_path_factory):
    ids, labels = _batch()
    return run_ranks(2, "ernie_parallel",
                     (master, ids, labels, GRIDS, STEPS, LOWP_GRIDS,
                      _layer_case()),
                     str(tmp_path_factory.mktemp("ernie")))


@pytest.fixture(scope="module")
def reference(master):
    ids, labels = _batch()
    return reference_run(master, STEPS, ids, labels)


@pytest.mark.parametrize("grid", GRIDS, ids=[g[0] for g in GRIDS])
def test_hybrid_ernie_matches_the_reference_trajectory(grid, master,
                                                       reference, ranks):
    name = grid[0]
    want, want_params = reference
    got = ranks[0]["losses"][name]
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    errs = delta_errs(ranks[0]["params"][name], want_params, master)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= DELTA_TOL, (name, worst, errs[worst])


def test_lowp_int8_under_mp2_matches_world_one_and_the_reference(master,
                                                                 ranks):
    ids, labels = _batch()
    want, _ = reference_run(master, STEPS, ids, labels, lowp="int8")
    got = ranks[0]["lowp"]
    w1 = got["lowp.w1"]
    np.testing.assert_allclose(w1, want, rtol=LOWP_RTOL)
    for name in ("lowp.mp2", "lowp.mp2.seqpar"):
        np.testing.assert_allclose(got[name], w1, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[name], want, rtol=LOWP_RTOL,
                                   err_msg=name)


def test_lowp_codes_at_mp2_equal_the_single_rank(ranks):
    """The column-parallel product's operands: the whole input and this
    rank's columns, with the whole weight's abs-max; the row-parallel
    one's: this rank's input features and weight rows, with the whole
    tensors' abs-maxes. The int8 codes of every shard are the single
    rank's codes of that shard."""
    x, w_col, w_row = _layer_case()
    amax = lambda a: tlowp.amax_of(torch.tensor(a))  # noqa: E731
    codes = lambda a, s: tlowp.quant_int8(  # noqa: E731
        torch.tensor(a), torch.tensor(s)).numpy()
    h_full = np.concatenate([r["layers"]["col_out"] for r in ranks], -1)
    want_h = tlowp.scaled_matmul(torch.tensor(x), torch.tensor(w_col),
                                 qdtype="int8").numpy()
    np.testing.assert_array_equal(h_full, want_h)
    want_y = tlowp.scaled_matmul(torch.tensor(want_h), torch.tensor(w_row),
                                 qdtype="int8").numpy()
    for r, res in enumerate(ranks):
        calls = res["layers"]["calls"]
        assert len(calls) == 2
        (ca, cb, csa, csb), (ra, rb, rsa, rsb) = calls
        n = w_col.shape[1] // 2
        k = w_row.shape[0] // 2
        assert csa == amax(x).numpy() and csb == amax(w_col).numpy()
        assert rsa == amax(want_h).numpy() and rsb == amax(w_row).numpy()
        np.testing.assert_array_equal(codes(cb, csb), codes(
            w_col, csb)[:, r * n:(r + 1) * n])
        np.testing.assert_array_equal(codes(ca, csa), codes(x, csa))
        np.testing.assert_array_equal(codes(ra, rsa), codes(
            want_h, rsa)[..., r * k:(r + 1) * k])
        np.testing.assert_array_equal(codes(rb, rsb), codes(
            w_row, rsb)[r * k:(r + 1) * k])
        np.testing.assert_allclose(res["layers"]["row_out"], want_y,
                                   rtol=1e-6, atol=1e-6)


def test_use_parallel_at_degree_one_is_the_dense_model(master):
    """Without a hybrid group ``use_parallel=True`` builds the dense
    layers under the same names and shapes, and its forward and loss
    equal ``use_parallel=False``'s on the same weights (the fused LM-head
    loss off, as the reference's predicate has it under use_parallel)."""
    ids, labels = _batch()
    out = {}
    for par in (True, False):
        cfg = ternie.ErnieConfig(**ERNIE_DIST, dropout=0.0, attn_dropout=0.0,
                                 use_parallel=par)
        model = ternie.ErnieForPretraining(cfg, device="cpu")
        weights.from_paddle_tpu_values(master, model)
        crit = ternie.ErniePretrainingCriterion(cfg)
        with torch.no_grad():
            scores, rel = model(torch.tensor(ids).long())
            if par:
                assert isinstance(scores, torch.Tensor)
                scores_t = scores
            else:
                scores_t = scores.materialize() if hasattr(
                    scores, "materialize") else scores
            loss = crit(scores, rel, torch.tensor(labels).long())
        out[par] = (scores_t.numpy(), rel.numpy(), float(loss))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(out[True][1], out[False][1])
    np.testing.assert_allclose(out[True][2], out[False][2], rtol=1e-6)
