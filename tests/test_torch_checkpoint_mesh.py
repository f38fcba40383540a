"""Meshed and hybrid checkpoints of the port against the reference's, on
the CPU: gloo ranks spawned once a world (tests/torch_gang_payload.py's
``mesh_all`` on 2 ranks, ``hybrid_roundtrip`` on 4), a tiny ERNIE (2
layers, hidden 32, dropout 0.1, AdamW) from the same numpy weights as
the reference.

- Layout-free manifests: at step 0 the `save_train_state` manifest of
  `Engine(mesh=)` at mp2 with sequence parallelism and at dp2 with ZeRO
  2 over dp (the global-norm clip, dynamic loss scaling and the guard
  on), on every rank, equals the port's engine at world size 1 and the
  reference's `Engine(mesh=)` at dp2 with ZeRO 2 (keys, shapes, dtypes
  and sha256); `save_hybrid_state` at mp2 with sequence parallelism and
  at sharding2 with ZeRO 2 equals the reference's `save_hybrid_state`
  (``block_params`` at ``[pp, L/pp, ...]``, ``rest_params``,
  ``rest_buffers``, ``opt_state`` with ``blocks`` and ``rest``).
- The resharded restore: a checkpoint written at dp2 with ZeRO 2 after
  2 steps restores into engines of other weights at world size 1, at
  mp2 and at dp2 with ZeRO 1; the restored engine's global payload
  hashes to the checkpoint's manifest leaf for leaf, and its 3rd step's
  loss is within rtol 1e-5 of the uninterrupted run's (f32 sums in
  other orders across the layouts; measured 1.2e-7).
- The hybrid round trip, the port's counterpart of
  tests/test_checkpoint.py:98-141 and 261-316 on 4 ranks: mp2 x pp2 and
  pp2 x sharding2 under ZeRO 3 with offload (its parameters really
  rest as ZeRO slices); a fresh engine of other weights restored with
  `load_hybrid_state` takes the next step bit for bit like the original
  (rtol 0), and the ZeRO-3 checkpoint restored at mp2 x pp2 takes it
  within rtol 1e-5.
- The meshed guard's rollback against the reference's `Engine(mesh=)`
  rollback: an MLP at dp2 with the guard (SGD 0.1,
  FLAGS_anomaly_max_bad_steps 2, checked every step), a checkpoint
  after step 2, ``train.batch@3-4:nan``: on every rank one rollback,
  the engine back at step 2 with its counter 0 after step 4, the
  reference's warning word for word, the step and counter trajectory
  equal to the reference's and its losses within rtol 1e-5 (the
  packages' matmuls sum in other orders), and the replayed steps equal
  the port's clean run's steps 3-4 bit for bit.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.hybrid import make_ernie_hybrid_engine as jhybrid
from paddle_tpu.distributed.topology import (
    set_hybrid_communicate_group as jset_hcg,
)
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.framework import faults as jfaults
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.nlp.transformers import (
    ErnieConfig as JErnieConfig, ErnieForPretraining as JErnie,
    ErniePretrainingCriterion as JCriterion,
)

from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.nlp.transformers import ernie as ternie

import torch_gang_payload as payload
from torch_dist_workers import run_ranks

RESTORE_RTOL = 1e-5
PARITY_RTOL = 1e-5


def _manifest(path):
    with open(os.path.join(path, "paddle_manifest.json")) as f:
        return json.load(f)


def _mlp_values(seed=2):
    rng = np.random.RandomState(seed)
    return {"0.weight": rng.randn(8, 16).astype(np.float32) * 0.3,
            "0.bias": rng.randn(16).astype(np.float32) * 0.1,
            "2.weight": rng.randn(16, 4).astype(np.float32) * 0.3,
            "2.bias": rng.randn(4).astype(np.float32) * 0.1}


def _mlp_batch():
    rng = np.random.RandomState(3)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


@pytest.fixture(scope="module")
def master():
    return payload.master_values(5)


@pytest.fixture(scope="module")
def ranks(master, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    x, y = _mlp_batch()
    res = run_ranks(2, "torch_gang_payload:mesh_all",
                    (master, payload.master_values(9), _mlp_values(), x, y,
                     tmp), tmp, timeout=300)
    return tmp, res


@pytest.fixture(scope="module")
def hybrid_ranks(master, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hybrid"))
    return run_ranks(4, "torch_gang_payload:hybrid_roundtrip",
                     (master, payload.master_values(9), tmp), tmp,
                     timeout=300)


def _jgrid(dp=1):
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=strategy)
    return jfleet.get_hybrid_communicate_group()


def _jernie(master, **kw):
    m = JErnie(JErnieConfig(**payload.ERNIE_GANG, dropout=0.1,
                            attn_dropout=0.1, **kw))
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in master.items()})
    return m


@pytest.fixture(scope="module")
def reference(master, tmp_path_factory):
    """The reference's step-0 manifests: `Engine(mesh=)` at dp2 with
    ZeRO 2 over dp, and `save_hybrid_state` of its hybrid ERNIE."""
    tmp = tmp_path_factory.mktemp("ref")
    try:
        hcg = _jgrid(dp=2)
        m = _jernie(master)
        opt = paddle.optimizer.AdamW(
            learning_rate=payload.GANG_LR, parameters=m.parameters(),
            weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        crit = JCriterion()
        eng = JEngine(m, opt, lambda out, y: crit(out[0], out[1], y),
                      mesh=hcg.get_mesh(), zero_stage=2, sharding_axis="dp",
                      loss_scale="dynamic", anomaly_guard=True)
        jckpt.save_train_state(str(tmp / "mesh"), eng)
        jset_hcg(None)
        hcg = _jgrid()
        m = _jernie(master, use_parallel=True)
        opt = paddle.optimizer.AdamW(learning_rate=payload.GANG_LR,
                                     parameters=m.parameters(),
                                     weight_decay=0.01)
        jckpt.save_hybrid_state(str(tmp / "hybrid"),
                                jhybrid(m, JCriterion(), opt, hcg))
    finally:
        jset_hcg(None)
    return {"mesh": _manifest(str(tmp / "mesh")),
            "hybrid": _manifest(str(tmp / "hybrid"))}


def test_world_one_manifest_equals_the_reference_meshed_one(master,
                                                            reference,
                                                            tmp_path):
    from paddle_tpu_torch import weights

    cfg = ternie.ErnieConfig(**payload.ERNIE_GANG, dropout=0.1,
                             attn_dropout=0.1, use_parallel=True)
    model = ternie.ErnieForPretraining(cfg, device="cpu")
    weights.shard_values(master, model)
    crit = ternie.ErniePretrainingCriterion(cfg)
    opt = topt.AdamW(learning_rate=payload.GANG_LR,
                     parameters=model.parameters(), weight_decay=0.01,
                     grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    eng = TEngine(model, opt, lambda out, y: crit(out[0], out[1], y),
                  device="cpu", loss_scale="dynamic", anomaly_guard=True)
    tckpt.save_train_state(str(tmp_path / "w1"), eng)
    assert _manifest(str(tmp_path / "w1")) == reference["mesh"]


@pytest.mark.parametrize("name", ["mesh.mp2sp", "mesh.dp2z2"])
def test_meshed_manifest_is_layout_free(name, ranks, reference):
    tmp, _ = ranks
    for rank in (0, 1):
        got = _manifest(os.path.join(tmp, "ckpt", f"{name}.r{rank}"))
        assert got == reference["mesh"], (name, rank)


@pytest.mark.parametrize("name", ["hybrid.mp2sp", "hybrid.sh2z2"])
def test_hybrid_manifest_equals_the_reference(name, ranks, reference):
    tmp, _ = ranks
    for rank in (0, 1):
        got = _manifest(os.path.join(tmp, "ckpt", f"{name}.r{rank}"))
        assert got == reference["hybrid"], (name, rank)
        blocks = [k for k in got if k.startswith("['block_params']")]
        assert blocks and all(got[k]["shape"][:2] == [1, 2]
                              for k in blocks)


@pytest.mark.parametrize("layout", ["w1", "mp2", "dp2.z1"])
def test_dp2_zero2_checkpoint_restores_on_another_layout(layout, ranks):
    _, res = ranks
    for r in res:
        ck = r["ckpt"]
        got = ck[layout]
        assert got["step"] == 2
        assert got["digests"] == ck["manifest"]
        np.testing.assert_allclose(got["loss"], ck["uninterrupted"],
                                   rtol=RESTORE_RTOL)
    assert res[0]["ckpt"][layout] == res[1]["ckpt"][layout]


@pytest.mark.parametrize("name", ["mp2.pp2", "pp2.sh2.z3off"])
def test_hybrid_round_trip_is_bitwise(name, hybrid_ranks):
    for r in hybrid_ranks:
        got = r[name]
        assert got["resumed"] == got["next"]
        assert got["step"] == 3
        if name == "pp2.sh2.z3off":
            assert got["shards"], "no parameter rests as a ZeRO-3 slice"
        np.testing.assert_allclose(r["z3off.into.mp2.pp2"],
                                   r["pp2.sh2.z3off"]["next"],
                                   rtol=RESTORE_RTOL)


def _reference_rollback(tmp):
    """The reference's `Engine(mesh=)` at dp2 through the same fault
    schedule as `torch_gang_payload.mesh_rollback`."""
    prev = jflags.get_flags(["FLAGS_anomaly_max_bad_steps",
                             "FLAGS_anomaly_check_interval"])
    x, y = _mlp_batch()
    try:
        hcg = _jgrid(dp=2)
        model = paddle.nn.Sequential(paddle.nn.Linear(8, 16),
                                     paddle.nn.ReLU(),
                                     paddle.nn.Linear(16, 4))
        model.set_state_dict({k: paddle.to_tensor(v)
                              for k, v in _mlp_values().items()})
        eng = JEngine(model, paddle.optimizer.SGD(
            0.1, parameters=model.parameters()),
            lambda out, t: ((out - t) ** 2).mean(), mesh=hcg.get_mesh(),
            anomaly_guard=True)
        jflags.set_flags({"FLAGS_anomaly_max_bad_steps": 2,
                          "FLAGS_anomaly_check_interval": 1})
        mgr = jckpt.CheckpointManager(str(tmp))
        eng.attach_checkpoint_manager(mgr)
        before = jmonitor.stat_get("anomaly_rollbacks")
        rows = []
        with warnings.catch_warnings(record=True) as seen, \
                jfaults.inject("train.batch@3-4:nan"):
            warnings.simplefilter("always")
            for step in range(6):
                loss = float(eng.train_batch((x,), (y,)).item())
                rows.append((loss, eng.state.step,
                             int(eng.state.buffers["__anomaly_bad_steps__"])))
                if step == 1:
                    mgr.save_engine(2, eng)
        return {"rows": rows,
                "rollbacks": jmonitor.stat_get("anomaly_rollbacks") - before,
                "warnings": [str(w.message) for w in seen
                             if "anomaly guard" in str(w.message)]}
    finally:
        jflags.set_flags(prev)
        jset_hcg(None)


def test_meshed_rollback_matches_the_reference(ranks, tmp_path):
    _, res = ranks
    want = _reference_rollback(tmp_path)
    assert want["rollbacks"] == 1
    for r in res:
        got, clean = r["faulted"], r["clean"]
        assert got["rollbacks"] == 1 and clean["rollbacks"] == 0
        assert got["warnings"] == want["warnings"]
        assert [row[1:] for row in got["rows"]] == \
            [row[1:] for row in want["rows"]]
        assert got["rows"][3][1:] == (2, 0)     # back at step 2, re-armed
        g = np.array([row[0] for row in got["rows"]])
        w = np.array([row[0] for row in want["rows"]])
        assert np.isnan(g[2:4]).all() and np.isnan(w[2:4]).all()
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=PARITY_RTOL)
        # the replay after the rollback is the clean run's steps 3-4
        assert [row[0] for row in got["rows"][4:]] == \
            [row[0] for row in clean["rows"][2:4]]
    # by repr: a NaN loss equals itself there
    assert repr(res[0]["faulted"]["rows"]) == repr(res[1]["faulted"]["rows"])
