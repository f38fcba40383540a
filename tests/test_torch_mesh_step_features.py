"""The single-card engine's step features under a mesh, against the
reference's single-device `Engine`.

Two gloo ranks on the CPU (spawned once for the module through
tests/torch_dist_workers.py) train the narrow ERNIE of
tests/test_torch_ernie_parallel.py at dropout 0 from the reference's
numpy weights:

* the global gradient norm (``FLAGS_record_grad_norm``) and
  `ClipGradByGlobalNorm` under mp2 with sequence parallelism, sharding2
  under ZeRO 1, 2 and 3 (meshed `Engine`) and pp2 (hybrid engine, the
  tied table counted once over the stages): each step's norm and loss
  within rtol 1e-5 of the reference's (clipping active: the norm is
  above the clip); `ClipGradByNorm` under mp2 (a split parameter's norm
  over its shards);
* dynamic loss scaling with the anomaly guard at dp2 and mp2 with
  sequence parallelism, the attention mask NaN on the rows of the second
  rank's dp slice at step 2: every step's loss (NaN at step 2), the
  scale, its good / bad step counters and the guard's counter equal the
  reference's one-device run on the same global batches, and every rank
  agrees;
* an inf planted in the gradient of the second rank's shard of a
  column-parallel weight only, at mp2: every rank skips that step and
  the scale's trajectory equals world size 1's with the same inf (a
  rank that judged its own shard alone would step on, and the ranks
  would part);
* ``comm_dtype="bfloat16"`` at dp2: within the single-card comm_dtype
  tolerance of tests/test_torch_amp.py (losses rtol 2e-2) of the
  reference's ``Engine(comm_dtype="bfloat16")``, with the dp gradient
  reduction in bfloat16.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.engine import (  # noqa: E402
    ANOMALY_BAD_STEPS_KEY, BAD_STEPS_KEY, GOOD_STEPS_KEY, GRAD_NORM_KEY,
    LOSS_SCALE_KEY, Engine as JEngine,
)
from paddle_tpu.framework.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.nlp.transformers import (  # noqa: E402
    ErnieForPretraining, ErniePretrainingCriterion,
)

from test_torch_ernie_parallel import (  # noqa: E402
    _batch, _config, _master,
)
from torch_dist_workers import ERNIE_DIST, ERNIE_LR, run_ranks  # noqa: E402

STEPS = 3
CLIP, CLIP_NORM = 0.5, 0.05
SCALE = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
             decr_every_n_nan_or_inf=1)
MP2SP = (1, 2, 1, 1, 0, True)
GLOBAL = ("ClipGradByGlobalNorm", CLIP)
# (name, grid, hybrid engine, features)
GRIDS = [("clip.mp2.seqpar", MP2SP, False, {"grad_clip": GLOBAL}),
         ("clip.sharding2.z1", (1, 1, 1, 2, 1, False), False,
          {"grad_clip": GLOBAL}),
         ("clip.sharding2.z2", (1, 1, 1, 2, 2, False), False,
          {"grad_clip": GLOBAL}),
         ("clip.sharding2.z3", (1, 1, 1, 2, 3, False), False,
          {"grad_clip": GLOBAL}),
         ("clip.pp2", (1, 1, 2, 1, 0, False), True, {"grad_clip": GLOBAL}),
         ("clipnorm.mp2", (1, 2, 1, 1, 0, False), False,
          {"grad_clip": ("ClipGradByNorm", CLIP_NORM)}),
         ("comm.dp2", (2, 1, 1, 1, 0, False), False,
          {"comm_dtype": "bfloat16"})]
SCALED = [("scale.dp2", (2, 1, 1, 1, 0, False)), ("scale.mp2.seqpar", MP2SP)]
PLANT = [("plant.mp2", (1, 2, 1, 1, 0, False)),
         ("plant.w1", (1, 1, 1, 1, 0, False))]
PLANTED = "ernie.encoder.0.fc1.weight"


def _mask_batches():
    """(ids, labels, (token types, positions, attention mask)) for 4
    steps; at step 2 the mask is NaN on rows 4-7, the second dp rank's
    slice."""
    ids, labels = _batch()
    b, s = ids.shape
    types = np.zeros((b, s), np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    out = []
    for k in range(4):
        mask = np.ones((b, s), np.float32)
        if k == 1:
            mask[4:] = np.nan
        out.append((ids, labels, (types, pos, mask)))
    return out


def _reference(master, batches, steps, ids, labels, **kw):
    """The reference's one-device run: per step [loss, grad norm] (or,
    given `batches`, [loss, scale, good, bad, guard counter])."""
    opt_kw = {}
    clip = kw.pop("grad_clip", None)
    if clip is not None:
        opt_kw["grad_clip"] = getattr(paddle.nn, clip[0])(clip[1])
    jset_flags({"FLAGS_record_grad_norm": batches is None})
    try:
        jm = ErnieForPretraining(_config())
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in master.items()})
        crit = ErniePretrainingCriterion()
        eng = JEngine(jm, paddle.optimizer.SGD(
            learning_rate=ERNIE_LR, parameters=jm.parameters(), **opt_kw),
            lambda out, y: crit(out[0], out[1], y), **kw)
        rows = []
        if batches is None:
            for _ in range(steps):
                loss = float(eng.train_batch((ids,), (labels,)).item())
                rows.append([loss, float(eng.state.buffers[GRAD_NORM_KEY])])
            return rows
        for ids_k, lbl_k, inputs in batches:
            loss = float(eng.train_batch((ids_k, *inputs),
                                         (lbl_k,)).item())
            bufs = eng.state.buffers
            rows.append([loss] + [float(bufs[k]) for k in (
                LOSS_SCALE_KEY, GOOD_STEPS_KEY, BAD_STEPS_KEY,
                ANOMALY_BAD_STEPS_KEY)])
        return rows
    finally:
        jset_flags({"FLAGS_record_grad_norm": False})


@pytest.fixture(scope="module")
def master():
    return _master()


@pytest.fixture(scope="module")
def ranks(master, tmp_path_factory):
    ids, labels = _batch()
    scaled = [(name, grid, {"loss_scale": SCALE, "anomaly_guard": True})
              for name, grid in SCALED]
    plant = [(name, grid, PLANTED, 2, name == "plant.mp2")
             for name, grid in PLANT]
    return run_ranks(2, "mesh_features",
                     (master, ids, labels, (_mask_batches(), scaled), GRIDS,
                      STEPS, plant),
                     str(tmp_path_factory.mktemp("features")))


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] != "comm.dp2"],
                         ids=[g[0] for g in GRIDS if g[0] != "comm.dp2"])
def test_clipped_trajectory_and_global_norm_are_one_devices(grid, master,
                                                           ranks):
    name, feats = grid[0], grid[3]
    ids, labels = _batch()
    want = np.asarray(_reference(master, None, STEPS, ids, labels,
                                 grad_clip=feats["grad_clip"]))
    res = ranks[0]
    np.testing.assert_allclose(res["losses"][name], want[:, 0], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(res["norms"][name], want[:, 1], rtol=1e-5,
                               err_msg=name)
    if name.startswith("clip."):
        assert want[0, 1] > CLIP     # clipping is active


def test_dynamic_scale_and_guard_with_a_nan_on_one_rank(master, ranks):
    want = np.asarray(_reference(master, _mask_batches(), None, None, None,
                                 loss_scale=SCALE, anomaly_guard=True))
    # step 2 is skipped: the scale halves, the guard counts it
    assert np.isnan(want[1, 0]) and want[1, 1] == want[0, 1] / 2 and \
        want[1, 4] == 1
    for name, _grid in SCALED:
        got = np.asarray(ranks[0]["scaled"][name])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5,
                                   equal_nan=True, err_msg=name)
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:],
                                      err_msg=name)


def test_inf_on_one_shard_skips_the_step_on_every_rank(ranks):
    got = np.asarray(ranks[0]["planted"]["plant.mp2"])
    want = np.asarray(ranks[0]["planted"]["plant.w1"])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    # step 2 skipped: the scale halved, the bad-step counter reset by it
    assert want[1, 1] == SCALE["init_loss_scaling"] / 2


def test_comm_dtype_under_dp2_matches_the_reference(master, ranks):
    ids, labels = _batch()
    want = np.asarray(_reference(master, None, STEPS, ids, labels,
                                 comm_dtype="bfloat16"))
    np.testing.assert_allclose(ranks[0]["losses"]["comm.dp2"], want[:, 0],
                               rtol=2e-2)
    assert "torch.bfloat16" in ranks[0]["comm_dtypes"]["comm.dp2"]
    assert ERNIE_DIST["num_layers"] == 2
