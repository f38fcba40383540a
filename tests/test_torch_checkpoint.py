"""Port parity: paddle_tpu_torch's single-process checkpointing
(`distributed.checkpoint`), preemption resume and the engine's anomaly
rollback against paddle_tpu's, on the CPU.

- Manifests. A 2-layer ERNIE (AdamW, the guard and FLAGS_record_grad_norm
  on) and a ResNet-18 (Momentum, BN running stats, the guard) get the
  same weights in both packages (`weights.from_paddle_tpu_values`). At
  step 0 each package's ``save_train_state`` writes the same
  ``paddle_manifest.json``: equal keys, shapes, dtypes and sha256. After
  2 steps on the same batch the keys, shapes and dtypes are equal, and
  the values (the port's read with numpy alone, the reference's through
  its own ``load_state``) agree within each model's own parity
  tolerance: test_torch_optimizer.py's rtol 1e-6 holds where both
  packages update the same gradients, but a model's gradients differ by
  f32 summation order. ERNIE: rtol 1e-4, atol 1e-5 as
  test_torch_ernie.py holds its trajectories (measured: 1.2e-6 at
  most), the attention key bias, whose gradient is 0 up to rounding,
  within 2 lr a step of it. ResNet-18: each leaf's change over the two
  steps within 1.5e-2 of the change's L2 norm (the reference against
  itself with its input moved by 1e-6 spreads up to 1.11e-2 over 4
  draws; the port measured 1.05e-2), as test_torch_resnet.py measures
  one step.
- Kill-and-resume: port against port bitwise (rtol 0, atol 0), a tiny
  ERNIE with dropout resumed by an engine of other weight and engine
  seeds (the engine's RngState comes back); an MLP's resumed losses
  against the reference's resumed losses within rtol 1e-5 (measured
  1.8e-6: the two packages' matmuls sum in other orders, and two Adam
  steps magnify it past test_torch_optimizer.py's 1e-6, which holds an
  update of the same gradients).
- Rollback (``train.batch@3-4:nan``, FLAGS_anomaly_max_bad_steps 2):
  the replay is bitwise against a clean guarded run, on an MLP and on a
  ResNet-18 whose every leaf (BN running stats included) hashes to the
  clean run's at the checkpoint; the rollback count, the rewound step
  and the replayed losses (rtol 1e-5, as above) equal the reference's; without a
  manager the rollback raises PreconditionNotMetError; the counter is
  read every FLAGS_anomaly_check_interval steps (counted) and never by
  an unguarded engine; a rollback dumps a black box with its note and
  the last steps.
- Atomicity and corruption, the async manager (a snapshot immune to the
  in-place steps that follow it, bitwise; a background failure surfaces
  on `wait_until_finished`), `train_epoch_range` (resume, the LR
  scheduler, simulated preemption: marker, PreemptedError, a bitwise
  resume; sync and async) and the persistables, as the reference's
  own tests pin them (exact counts, bitwise values).

A fixture restores every global this file changes: the flags of both
packages, the fault specs and hit counters of both, the preemption state
and signal handlers of both, and the flight ring.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import engine as jengine
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import preempt as jpreempt
from paddle_tpu.engine import state_values
from paddle_tpu.framework import faults as jfaults
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.nlp.transformers.ernie import (
    ErniePretrainingCriterion as JCrit,
)
from paddle_tpu.vision.models import resnet as jresnet

from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observe
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed import preempt
from paddle_tpu_torch.framework import faults, flags, monitor
from paddle_tpu_torch.framework.errors import PreconditionNotMetError
from paddle_tpu_torch.nlp.transformers import ernie as ternie
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.vision.models import resnet as tresnet
from test_torch_resnet import resnet_values
from torch_parity import ERNIE_TINY, VOCAB, build_ernie_pair

_FLAGS = ("FLAGS_anomaly_max_bad_steps", "FLAGS_anomaly_check_interval",
          "FLAGS_ckpt_verify_checksums", "FLAGS_simulate_preempt_at_step",
          "FLAGS_record_grad_norm")
ERNIE_LR = 1e-3


@pytest.fixture(autouse=True)
def _restore_globals(tmp_path):
    saved = (flags.get_flags(list(_FLAGS)), jflags.get_flags(list(_FLAGS)),
             flags.get_flags("FLAGS_flight_recorder_dir"))
    specs = [(m._specs[:], dict(m._hits)) for m in (faults, jfaults)]
    ring = observe.flight
    saved_ring = (ring._ring, list(ring._notes), list(ring._dumped))
    ring.reset()
    for p in (preempt, jpreempt):
        p.clear()
    flags.set_flags({"FLAGS_flight_recorder_dir": str(tmp_path / "bb")})
    yield
    for p in (preempt, jpreempt):
        p.uninstall()
        p.clear()
    for m, (sp, hits) in zip((faults, jfaults), specs):
        m._specs[:] = sp
        m._hits.clear()
        m._hits.update(hits)
    ring._ring = saved_ring[0]
    ring._notes.clear()
    ring._notes.extend(saved_ring[1])
    ring._dumped[:] = saved_ring[2]
    flags.set_flags({**saved[0], **saved[2]})
    jflags.set_flags(saved[1])


def _both_flags(values):
    flags.set_flags(values)
    jflags.set_flags(values)


def _stat(name):
    return monitor.stat_get(name)


def _numpy_checkpoint(path):
    """A port checkpoint read with numpy alone: {key: array}, bfloat16
    leaves as their uint16 words."""
    with open(os.path.join(path, "d", "index.json")) as f:
        index = json.load(f)
    return {k: np.load(os.path.join(path, "d", e["file"]),
                       allow_pickle=False) for k, e in index.items()}


def _reference_checkpoint(path, jeng):
    restored = jckpt.load_state(path, jckpt._engine_payload(jeng)[0])
    return {jax.tree_util.keystr(kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(
                restored)[0]}


def _payload_digests(eng):
    return ckpt.leaf_digests(ckpt._engine_payload(eng)[0])


# -- small models ---------------------------------------------------------------


class _MLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(12, 24)
        self.fc2 = tnn.Linear(24, 4)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class _JMLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(12, 24)
        self.fc2 = paddle.nn.Linear(24, 4)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


def _mlp_values(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1.weight": 0.3 * rng.randn(12, 24).astype(np.float32),
            "fc1.bias": 0.1 * rng.randn(24).astype(np.float32),
            "fc2.weight": 0.3 * rng.randn(24, 4).astype(np.float32),
            "fc2.bias": 0.1 * rng.randn(4).astype(np.float32)}


def _mlp_batch():
    rs = np.random.RandomState(0)
    return (rs.randn(8, 12).astype(np.float32),
            rs.randn(8, 4).astype(np.float32))


def _mse(o, y):
    return ((o - y) ** 2).mean()


def _mlp(seed=5, values=None, lr=0.05, **kw):
    """The port's MLP engine on the CPU; `values` (numpy) or weights
    drawn from torch seed `seed`; the engine's RngState from `seed`."""
    torch.manual_seed(seed)
    m = _MLP()
    if values is not None:
        m.load_state_dict({k: torch.from_numpy(v) for k, v in values.items()})
    opt = topt.Adam(learning_rate=lr, parameters=m.parameters())
    return tengine.Engine(m, opt, _mse, device="cpu", seed=seed, **kw)


def _jmlp(values, lr=0.05, **kw):
    m = _JMLP()
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in values.items()})
    opt = paddle.optimizer.Adam(learning_rate=lr, parameters=m.parameters())
    return jengine.Engine(m, opt, lambda o, y: paddle.mean((o - y) * (o - y)),
                          **kw)


def _losses(eng, batch, n):
    x, y = batch
    return [float(np.asarray(eng.train_batch(x, y))) for _ in range(n)]


def _jlosses(eng, batch, n):
    x, y = batch
    return [float(np.asarray(eng.train_batch(x, y)._value))
            for _ in range(n)]


def _resnet(seed=0, **kw):
    m = tresnet.resnet18(num_classes=4, space_to_depth_stem=True,
                         device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    opt = topt.Momentum(learning_rate=0.001, momentum=0.9,
                        parameters=m.parameters(), weight_decay=1e-4)
    crit = tnn.CrossEntropyLoss()
    return tengine.Engine(m, opt, lambda lg, y: crit(lg, y), device="cpu",
                          seed=seed, **kw)


def _resnet_batch(n=4, hw=32):
    rng = np.random.RandomState(4)
    return (rng.rand(n, 3, hw, hw).astype(np.float32),
            rng.randint(0, 4, (n,)).astype(np.int64))


# -- the manifest against the reference's ---------------------------------------


def _ernie_pair():
    jm, tm, vals = build_ernie_pair(seed=0)

    def no_decay(name):
        return not (name.endswith("bias") or "norm" in name)

    jcrit, tcrit = JCrit(), ternie.ErniePretrainingCriterion()
    jeng = jengine.Engine(
        jm, paddle.optimizer.AdamW(
            learning_rate=ERNIE_LR, parameters=jm.parameters(),
            weight_decay=0.01, apply_decay_param_fun=no_decay),
        lambda out, mlm, nsp: jcrit(out[0], out[1], mlm, nsp),
        anomaly_guard=True)
    teng = tengine.Engine(
        tm, topt.AdamW(learning_rate=ERNIE_LR, parameters=tm.parameters(),
                       weight_decay=0.01, apply_decay_param_fun=no_decay),
        lambda out, mlm, nsp: tcrit(out[0], out[1], mlm, nsp),
        device="cpu", anomaly_guard=True)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (2, 32)).astype(np.int32)
    types = rng.randint(0, 2, (2, 32)).astype(np.int32)
    mlm = ids.copy()
    mlm[rng.rand(2, 32) > 0.3] = -100
    nsp = rng.randint(0, 2, (2,)).astype(np.int32)
    return jeng, teng, ((ids, types), (mlm, nsp))


def _resnet_pair():
    paddle.seed(0)
    jm = jresnet.resnet18(num_classes=4, space_to_depth_stem=True)
    vals = resnet_values([(k, tuple(np.shape(v)))
                          for k, v in state_values(jm).items()], 0)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    jcrit = paddle.nn.CrossEntropyLoss()
    jeng = jengine.Engine(jm, paddle.optimizer.Momentum(
        learning_rate=0.001, momentum=0.9, parameters=jm.parameters(),
        weight_decay=1e-4), lambda lg, y: jcrit(lg, y), anomaly_guard=True)
    teng = _resnet(anomaly_guard=True)
    weights.from_paddle_tpu_values(vals, teng.layer)
    return jeng, teng, _resnet_batch(4, 64)


def _split_key_bias(key, a):
    if not key.endswith("qkv_proj.bias']"):
        return a, None
    h = a.shape[0] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


@pytest.mark.parametrize("model", ["ernie", "resnet"])
def test_manifest_matches_reference(model, tmp_path):
    """Step 0: both packages' manifests equal, digests included (exact).
    After 2 steps: keys, shapes and dtypes equal (exact); values within
    the model's parity tolerance (ERNIE rtol 1e-4, atol 1e-5, key bias
    within 2 lr a step; ResNet-18 each leaf's change within 1.5e-2 of
    its L2 norm), as the module docstring measures."""
    if model == "ernie":
        _both_flags({"FLAGS_record_grad_norm": True})
        jeng, teng, (inputs, labels) = _ernie_pair()
    else:
        jeng, teng, (inputs, labels) = _resnet_pair()
    jckpt.save_train_state(str(tmp_path / "j0"), jeng)
    ckpt.save_train_state(str(tmp_path / "t0"), teng)
    want = jckpt.load_manifest(str(tmp_path / "j0"))
    got = ckpt.load_manifest(str(tmp_path / "t0"))
    assert len(got) == (187 if model == "ernie" else 165)
    assert got == want
    t0 = _numpy_checkpoint(str(tmp_path / "t0"))
    for _ in range(2):
        jeng.train_batch(inputs, labels)
        teng.train_batch(inputs, labels)
    jckpt.save_train_state(str(tmp_path / "j2"), jeng)
    ckpt.save_train_state(str(tmp_path / "t2"), teng)
    want = jckpt.load_manifest(str(tmp_path / "j2"))
    got = ckpt.load_manifest(str(tmp_path / "t2"))
    assert {k: (v["shape"], v["dtype"]) for k, v in got.items()} == \
        {k: (v["shape"], v["dtype"]) for k, v in want.items()}
    tvals = _numpy_checkpoint(str(tmp_path / "t2"))
    jvals = _reference_checkpoint(str(tmp_path / "j2"), jeng)
    assert set(tvals) == set(jvals)
    for k, w in jvals.items():
        g = tvals[k]
        assert g.dtype == w.dtype, k
        if model == "ernie":
            (g, g_key), (w, w_key) = (_split_key_bias(k, a) for a in (g, w))
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            if w_key is not None and k.startswith("['params']"):
                assert np.abs(g_key - w_key).max() <= 2 * ERNIE_LR * 2, k
        else:
            moved = np.linalg.norm(w.astype(np.float64) - t0[k])
            err = np.linalg.norm(g.astype(np.float64) - w)
            assert err <= 1.5e-2 * moved, (k, err / max(moved, 1e-30))


def test_manifest_keys_and_bfloat16_digests_match_reference(tmp_path):
    """The port's keystr notation and dtype names on a tree of every
    node kind, and a bf16 leaf stored as its raw words: its manifest
    equals the reference's of the same values (exact, digests included);
    the tree round-trips bitwise, `verify_manifest` passes it and fails
    a changed leaf, and a template of another dtype is refused."""
    from paddle_tpu_torch.quantization.scaling import ScaleState

    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 5).astype(np.float32)
    bf = torch.from_numpy(rng.randn(4, 2).astype(np.float32)).bfloat16()
    nt = ScaleState(*(np.full((2,), i, np.float32)
                      for i in range(len(ScaleState._fields))))
    tree = {"b": [f32, (np.int32(3),)], "a": {"x.w": bf},
            "n": nt, "e": {}, "z": None}
    jtree = {"b": [f32, (np.int32(3),)],
             "a": {"x.w": jax.numpy.asarray(bf.float().numpy(),
                                            jax.numpy.bfloat16)},
             "n": nt, "e": {}, "z": None}
    got = ckpt._manifest_of(tree)
    assert got == jckpt._manifest_of(jtree)
    assert got["['a']['x.w']"]["dtype"] == "bfloat16"
    assert list(got)[:2] == ["['a']['x.w']", "['b'][0]"]
    ckpt.save_state(str(tmp_path / "s"), tree)
    back = ckpt.load_state(str(tmp_path / "s"), tree)
    ckpt.verify_manifest(str(tmp_path / "s"), back)
    with pytest.raises(ValueError, match="checksum"):
        ckpt.verify_manifest(str(tmp_path / "s"), {**back, "b": [f32 + 1]})
    assert back["a"]["x.w"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["x.w"], bf)
    assert type(back["n"]) is ScaleState and back["z"] is None
    np.testing.assert_array_equal(back["b"][0], f32)
    with pytest.raises(ValueError, match="template wants"):
        ckpt.load_state(str(tmp_path / "s"), {**tree, "a": {
            "x.w": torch.zeros(4, 2)}})


# -- kill and resume -------------------------------------------------------------


def _ernie(weights_seed, engine_seed, **cfg):
    cfg = ternie.ErnieConfig(**dict(ERNIE_TINY, **cfg))
    m = ternie.ErnieForPretraining(
        cfg, device="cpu",
        generator=torch.Generator().manual_seed(weights_seed))
    crit = ternie.ErniePretrainingCriterion()
    opt = topt.AdamW(learning_rate=ERNIE_LR, parameters=m.parameters(),
                     weight_decay=0.01)
    return tengine.Engine(m, opt, lambda out, mlm, nsp: crit(out[0], out[1],
                                                             mlm, nsp),
                          device="cpu", seed=engine_seed)


def test_kill_and_resume_replays_dropout_bitwise(tmp_path):
    """A tiny ERNIE with hidden and attention dropout 0.1: the resumed
    engine, built from other weight and engine seeds, repeats the
    uninterrupted run's losses bit for bit (its RngState, the moments,
    the step and torch's default generator come back)."""
    rng = np.random.RandomState(1)
    ids = rng.randint(0, VOCAB, (2, 32)).astype(np.int32)
    mlm = ids.copy()
    mlm[rng.rand(2, 32) > 0.3] = -100
    batch = ((ids, np.zeros_like(ids)), (mlm, np.array([0, 1], np.int32)))
    drop = dict(dropout=0.1, attn_dropout=0.1)
    full = _losses(_ernie(0, 3, **drop), batch, 4)
    eng = _ernie(0, 3, **drop)
    assert _losses(eng, batch, 2) == full[:2]
    ckpt.save_train_state(str(tmp_path / "ck"), eng)
    torch.manual_seed(1234)              # the restore puts it back
    resumed = _ernie(7, 99, **drop)
    ckpt.load_train_state(str(tmp_path / "ck"), resumed)
    assert resumed.state.step == 2 and resumed.rng.seed == 3
    assert _losses(resumed, batch, 2) == full[2:]


def test_kill_and_resume_matches_reference(tmp_path):
    """The reference's kill-and-resume test on both packages, the same
    weights: the port resumes bitwise against its own uninterrupted run,
    and its resumed losses equal the reference's resumed ones within
    rtol 1e-5."""
    vals, batch = _mlp_values(), _mlp_batch()
    full = _losses(_mlp(values=vals, lr=0.01), batch, 4)
    eng = _mlp(values=vals, lr=0.01)
    _losses(eng, batch, 2)
    ckpt.save_train_state(str(tmp_path / "t"), eng)
    resumed = _mlp(seed=999, lr=0.01)
    ckpt.load_train_state(str(tmp_path / "t"), resumed)
    tl = _losses(resumed, batch, 2)
    assert tl == full[2:]

    jeng = _jmlp(vals, lr=0.01)
    _jlosses(jeng, batch, 2)
    jckpt.save_train_state(str(tmp_path / "j"), jeng)
    jres = _jmlp(_mlp_values(seed=9), lr=0.01)
    jckpt.load_train_state(str(tmp_path / "j"), jres)
    assert jres.state.step == resumed.state.step - 2 == 2
    np.testing.assert_allclose(tl, _jlosses(jres, batch, 2), rtol=1e-5)


# -- the anomaly guard's rollback --------------------------------------------------


def _rollback_run(make, batch, tmp_path):
    """`make()`'s engine, guarded, with a manager: 2 clean steps each
    followed by a save, then 2 poisoned steps (``train.batch@3-4:nan``)
    with FLAGS_anomaly_max_bad_steps 2 and a read every step."""
    _both_flags({"FLAGS_anomaly_max_bad_steps": 2,
                 "FLAGS_anomaly_check_interval": 1})
    eng = make()
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    eng.attach_checkpoint_manager(mgr)
    losses = []
    with faults.inject("train.batch@3-4:nan"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            losses += _losses(eng, batch, 1)
            mgr.save_engine(eng.state.step, eng)
        losses += _losses(eng, batch, 2)
    return eng, mgr, losses


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_rollback_replays_bitwise(model, tmp_path):
    """Port against port, bitwise: the pre-poison losses and the 4
    replayed ones equal a clean guarded run's (rtol 0, atol 0), and
    every leaf's sha256 after the rollback equals the clean run's at
    the checkpoint; exactly one rollback, to step 2."""
    if model == "mlp":
        make, batch = (lambda: _mlp(seed=8, anomaly_guard=True)), \
            _mlp_batch()
    else:
        make, batch = (lambda: _resnet(anomaly_guard=True)), _resnet_batch()
    clean = make()
    ref = _losses(clean, batch, 2)
    at_ckpt = _payload_digests(clean)
    ref += _losses(clean, batch, 4)
    before = _stat("anomaly_rollbacks")
    eng, _, losses = _rollback_run(make, batch, tmp_path)
    assert losses[:2] == ref[:2] and np.isnan(losses[2:]).all()
    assert _stat("anomaly_rollbacks") - before == 1
    assert eng.state.step == 2
    # every parameter, moment, running stat and the re-armed counter
    assert _payload_digests(eng) == at_ckpt
    if model == "resnet":
        assert "['buffers']['bn1._mean']" in at_ckpt
    assert _losses(eng, batch, 4) == ref[2:]


def test_rollback_count_and_step_match_reference(tmp_path):
    """The rollback count (1), the rewound step (2) and the NaN steps
    equal the reference's exactly; the losses before the poison and the
    3 replayed ones within rtol 1e-5 of the reference's."""
    vals, batch = _mlp_values(), _mlp_batch()
    jbefore, tbefore = jmonitor.stat_get("anomaly_rollbacks"), \
        _stat("anomaly_rollbacks")
    eng, _, tl = _rollback_run(
        lambda: _mlp(values=vals, anomaly_guard=True), batch, tmp_path / "t")
    jeng = _jmlp(vals, anomaly_guard=True)
    mgr = jckpt.CheckpointManager(str(tmp_path / "j"))
    jeng.attach_checkpoint_manager(mgr)
    jl = []
    with jfaults.inject("train.batch@3-4:nan"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            jl += _jlosses(jeng, batch, 1)
            mgr.save_engine(jeng.state.step, jeng)
        jl += _jlosses(jeng, batch, 2)
    assert jmonitor.stat_get("anomaly_rollbacks") - jbefore == \
        _stat("anomaly_rollbacks") - tbefore == 1
    assert eng.state.step == jeng.state.step == 2
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    np.testing.assert_allclose(_losses(eng, batch, 3) + tl[:2],
                               _jlosses(jeng, batch, 3) + jl[:2],
                               rtol=1e-5)


def test_rollback_without_manager_raises():
    """No manager attached: the first read that sees the budget spent
    raises PreconditionNotMetError (no tolerance)."""
    _both_flags({"FLAGS_anomaly_max_bad_steps": 1,
                 "FLAGS_anomaly_check_interval": 1})
    eng = _mlp(anomaly_guard=True)
    with faults.inject("train.batch@1:nan"):
        with pytest.raises(PreconditionNotMetError,
                           match="checkpoint manager"):
            _losses(eng, _mlp_batch(), 1)


def test_anomaly_check_interval_is_respected(tmp_path):
    """The counter is read on the host every FLAGS_anomaly_check_interval
    steps (4: steps 4 and 8), never by an unguarded engine, and a burst
    of bad steps rolls back at the first read that sees it."""
    _both_flags({"FLAGS_anomaly_max_bad_steps": 2,
                 "FLAGS_anomaly_check_interval": 4})
    reads = []

    def counted(eng):
        inner = eng._check_anomaly
        eng._check_anomaly = lambda: (reads.append(eng.state.step),
                                      inner())[1]
        return eng

    batch = _mlp_batch()
    _losses(counted(_mlp(anomaly_guard=True)), batch, 8)
    assert reads == [4, 8]
    reads.clear()
    _losses(counted(_mlp()), batch, 8)
    assert reads == []
    eng = counted(_mlp(anomaly_guard=True))
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    eng.attach_checkpoint_manager(mgr)
    mgr.save_engine(0, eng)
    with faults.inject("train.batch@1-4:nan"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _losses(eng, batch, 3)
        assert reads == [] and eng.state.step == 3
        assert int(eng.anomaly_bad_steps) == 3
        _losses(eng, batch, 1)
    assert reads == [4] and eng.state.step == 0
    assert int(eng.anomaly_bad_steps) == 0


def test_rollback_dumps_the_flight_box(tmp_path):
    """The rollback dumps one black box: its reason, the note's counts
    and the recorded steps exactly, the recorded loss bitwise equal to
    the returned one, the poisoned loss NaN."""
    eng, _, losses = _rollback_run(lambda: _mlp(seed=8, anomaly_guard=True),
                                   _mlp_batch(), tmp_path)
    (path,) = observe.flight.dumps()
    with open(path) as f:
        box = json.load(f)
    assert box["reason"] == "anomaly-rollback"
    note = next(n for n in box["notes"] if n["kind"] == "anomaly_rollback")
    assert note["bad_steps"] == 2 and note["engine_step"] == 4
    assert [r["step"] for r in box["records"]] == [1, 2, 3]
    assert box["records"][1]["loss"] == losses[1]
    assert np.isnan(box["records"][2]["loss"])
    assert box["records"][2]["anomaly_bad_steps"] == 1.0
    faults_fired = [n for n in box["notes"] if n["kind"] == "fault"]
    assert [n["hit"] for n in faults_fired] == [3, 4]


# -- atomicity and corruption ------------------------------------------------------


def test_crash_before_commit_leaves_no_torn_dir(tmp_path):
    """A raise between staging and the rename leaves the previous
    checkpoint restorable and the new step invisible (exact steps)."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    eng = _mlp()
    batch = _mlp_batch()
    _losses(eng, batch, 1)
    mgr.save_engine(1, eng)
    _losses(eng, batch, 1)
    with faults.inject("checkpoint.before_commit@1:raise"):
        with pytest.raises(faults.FaultError):
            mgr.save_engine(2, eng)
    # the staged tmp dir exists but is invisible to step enumeration
    assert os.path.isdir(str(tmp_path / "run" / "ckpt-2.tmp"))
    assert not os.path.exists(str(tmp_path / "run" / "ckpt-2"))
    assert mgr.all_steps() == [1]
    eng2 = _mlp(seed=777)
    step, _ = mgr.restore_with(lambda p: ckpt.load_train_state(p, eng2))
    assert step == 1 and eng2.state.step == 1
    # the next save replaces the stale tmp dir cleanly
    mgr.save_engine(2, eng)
    assert mgr.all_steps() == [1, 2]
    assert not os.path.exists(str(tmp_path / "run" / "ckpt-2.tmp"))


def test_checkpoint_io_errors_are_retried(tmp_path):
    """Two injected I/O errors are retried: exactly 2 ``ckpt_retries``,
    and the save restores (exact step)."""
    before = _stat("ckpt_retries")
    eng = _mlp()
    _losses(eng, _mlp_batch(), 1)
    with faults.inject("checkpoint.io@1-2:ioerror"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ckpt.save_train_state(str(tmp_path / "ck"), eng)
    assert _stat("ckpt_retries") - before == 2
    eng2 = _mlp(seed=42)
    ckpt.load_train_state(str(tmp_path / "ck"), eng2)
    assert eng2.state.step == 1


def test_checksum_mismatch_raises_and_restore_falls_back(tmp_path):
    """A manifest that no longer matches raises ValueError before the
    engine is touched (digests unchanged, exact); the flag skips the
    check; `restore_with` warns, counts 1 fallback and restores step 1."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    eng = _mlp()
    batch = _mlp_batch()
    _losses(eng, batch, 1)
    mgr.save_engine(1, eng)
    _losses(eng, batch, 1)
    mgr.save_engine(2, eng)
    mpath = str(tmp_path / "run" / "ckpt-2" / ckpt.MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    for rec in manifest.values():
        rec["sha256"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(manifest, f)

    victim = _mlp(seed=9)
    untouched = _payload_digests(victim)
    with pytest.raises(ValueError, match="checksum"):
        ckpt.load_train_state(str(tmp_path / "run" / "ckpt-2"), victim)
    assert _payload_digests(victim) == untouched and victim.state.step == 0
    # verification is flag-gated (escape hatch for forensics)
    flags.set_flags({"FLAGS_ckpt_verify_checksums": False})
    ckpt.load_train_state(str(tmp_path / "run" / "ckpt-2"), _mlp(seed=9))
    flags.set_flags({"FLAGS_ckpt_verify_checksums": True})

    eng3 = _mlp(seed=11)
    before = _stat("ckpt_restore_fallbacks")
    with pytest.warns(UserWarning, match="ckpt-2 unreadable"):
        step, _ = mgr.restore_with(
            lambda p: ckpt.load_train_state(p, eng3))
    assert step == 1 and eng3.state.step == 1
    assert _stat("ckpt_restore_fallbacks") - before == 1


@pytest.mark.parametrize("how", ["corrupt_leaf", "after_commit_fault"])
def test_truncated_leaf_detected_and_skipped(how, tmp_path):
    """A leaf file truncated to half (by `corrupt_leaf`, or by the
    ``corrupt`` action at ``checkpoint.after_commit``) is unreadable:
    `restore_with` counts exactly 1 fallback and restores step 1."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    eng = _mlp()
    batch = _mlp_batch()
    _losses(eng, batch, 1)
    mgr.save_engine(1, eng)
    _losses(eng, batch, 1)
    if how == "corrupt_leaf":
        mgr.save_engine(2, eng)
        victim = faults.corrupt_leaf(str(tmp_path / "run" / "ckpt-2"))
    else:
        with faults.ChaosSchedule("checkpoint.after_commit@1:corrupt") as c:
            mgr.save_engine(2, eng)
        assert c.verify() == {"checkpoint.after_commit": 1}
    assert mgr.all_steps() == [1, 2] and mgr.is_readable(2)
    eng2 = _mlp(seed=13)
    before = _stat("ckpt_restore_fallbacks")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step, _ = mgr.restore_with(lambda p: ckpt.load_train_state(p, eng2))
    assert step == 1 and eng2.state.step == 1
    assert _stat("ckpt_restore_fallbacks") - before == 1
    if how == "corrupt_leaf":
        assert os.sep + "d" + os.sep in victim


def test_restore_with_falls_back_on_real_torn_dir(tmp_path):
    """A committed-looking dir without manifest and metadata is not
    readable, and `restore_with` falls back to step 1 (exact)."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    eng = _mlp()
    _losses(eng, _mlp_batch(), 1)
    mgr.save_engine(1, eng)
    shutil.copytree(str(tmp_path / "run" / "ckpt-1"),
                    str(tmp_path / "run" / "ckpt-2"))
    os.remove(str(tmp_path / "run" / "ckpt-2" / ckpt.META_NAME))
    os.remove(str(tmp_path / "run" / "ckpt-2" / ckpt.MANIFEST_NAME))
    assert mgr.all_steps() == [1, 2] and not mgr.is_readable(2)
    eng2 = _mlp(seed=21)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step, _ = mgr.restore_with(lambda p: ckpt.load_train_state(p, eng2))
    assert step == 1 and eng2.state.step == 1


def test_gc_never_deletes_newest_readable(tmp_path):
    """Retention counts readable checkpoints only: torn newer dirs go,
    steps 2 and 5 stay, and step 5 restores bitwise."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    state = {"w": torch.zeros(4)}
    mgr.save(1, state)
    mgr.save(2, state)
    for s in (3, 4):
        os.makedirs(str(tmp_path / "run" / f"ckpt-{s}"))
        with open(str(tmp_path / "run" / f"ckpt-{s}" / "junk"), "w") as f:
            f.write("torn")
    before = _stat("ckpt_gc_removed")
    mgr.save(5, {"w": torch.full((4,), 5.0)})
    assert mgr.all_steps() == [2, 5] and mgr.readable_steps() == [2, 5]
    assert _stat("ckpt_gc_removed") - before >= 2
    restored, meta = mgr.restore(state)
    assert meta["step"] == 5 and torch.equal(restored["w"],
                                             torch.full((4,), 5.0))


# -- the async manager --------------------------------------------------------------


def test_async_snapshot_is_immune_to_in_place_steps(tmp_path):
    """The writer starts only after three more steps have updated the
    parameters and moments in place (a job queued ahead of it holds the
    writer thread): the checkpoint still holds the state at save time,
    bit for bit."""
    import threading

    eng = _mlp()
    batch = _mlp_batch()
    _losses(eng, batch, 2)
    at_save = _payload_digests(eng)
    mgr = ckpt.AsyncCheckpointManager(str(tmp_path / "run"))
    gate = threading.Event()
    mgr._executor.submit(gate.wait, 30)
    mgr.save_engine(2, eng)
    next_losses = _losses(eng, batch, 3)
    assert _payload_digests(eng) != at_save
    gate.set()
    mgr.wait_until_finished()
    back = _mlp(seed=31)
    step, _ = mgr.restore_with(lambda p: ckpt.load_train_state(p, back))
    assert step == 2 and _payload_digests(back) == at_save
    assert _losses(back, batch, 3) == next_losses
    mgr.close()


def test_async_save_does_not_block_step_thread(tmp_path):
    """With 0.8 s of injected write delay the save returns in < 0.4 s
    and the wait takes > 0.6 s; the async checkpoint resumes bitwise."""
    eng = _mlp()
    batch = _mlp_batch()
    _losses(eng, batch, 3)
    mgr = ckpt.AsyncCheckpointManager(str(tmp_path / "run"))
    before = _stat("ckpt_async_saves")
    with faults.inject("checkpoint.io@*:delay:0.8"):
        t0 = time.monotonic()
        mgr.save_engine(3, eng)
        t_save = time.monotonic() - t0
        t0 = time.monotonic()
        mgr.wait_until_finished()
        t_wait = time.monotonic() - t0
    assert t_save < 0.4, f"async save blocked the caller for {t_save}s"
    assert t_wait > 0.6, f"writer finished too fast ({t_wait}s)"
    assert _stat("ckpt_async_saves") - before == 1
    ref_next = _losses(eng, batch, 1)
    eng2 = _mlp(seed=404)
    step, _ = mgr.restore_with(lambda p: ckpt.load_train_state(p, eng2))
    assert step == 3 and eng2.state.step == 3
    assert _losses(eng2, batch, 1) == ref_next
    mgr.close()


def test_async_save_failure_surfaces_on_wait(tmp_path):
    """A write that fails every retry raises OSError on
    `wait_until_finished`; the manager then saves again, `save` of a
    plain tree included (exact steps, bitwise values)."""
    eng = _mlp()
    _losses(eng, _mlp_batch(), 1)
    mgr = ckpt.AsyncCheckpointManager(str(tmp_path / "run"))
    with faults.inject("checkpoint.io@*:ioerror"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr.save_engine(1, eng)
            with pytest.raises(OSError):
                mgr.wait_until_finished()
    mgr.save_engine(2, eng)
    w = torch.arange(4.0)
    mgr.save(3, {"w": w})
    w.add_(1.0)                         # after the snapshot: not saved
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 3]
    restored, meta = mgr.restore({"w": torch.zeros(4)})
    assert meta["step"] == 3 and torch.equal(restored["w"],
                                             torch.arange(4.0))
    mgr.close()


# -- train_epoch_range and preemption ------------------------------------------------


def _linear(seed=0, sched=None):
    torch.manual_seed(seed)
    m = tnn.Linear(4, 2)
    opt = topt.Adam(learning_rate=0.1 if sched is None else sched,
                    parameters=m.parameters())
    return tengine.Engine(m, opt, _mse, device="cpu", seed=seed)


def _xy():
    return (np.random.RandomState(0).randn(8, 4).astype(np.float32),
            np.random.RandomState(1).randn(8, 2).astype(np.float32))


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_train_epoch_range_resumes(async_save, tmp_path):
    """A run abandoned at epoch 2's yield (its snapshot never runs)
    resumes at epoch 2 and repeats the uninterrupted losses bit for
    bit."""
    x, y = _xy()
    eng = _linear()
    for epoch in ckpt.train_epoch_range(5, str(tmp_path), eng,
                                        async_save=async_save):
        eng.train_batch(x, y)
        if epoch == 2:
            break
    eng2 = _linear(seed=3)
    resumed, losses = [], []
    for epoch in ckpt.train_epoch_range(5, str(tmp_path), eng2,
                                        async_save=async_save):
        losses += _losses(eng2, (x, y), 1)
        resumed.append(epoch)
    assert resumed == [2, 3, 4], resumed
    assert losses == _losses(_linear(), (x, y), 5)[2:]


def test_train_epoch_range_restores_lr_scheduler(tmp_path):
    """The resumed scheduler's rate is exactly 0.05 (epoch 0's save:
    one step of StepDecay(0.1, 1, 0.5)); the layer's own weight holds
    the restored value bitwise."""
    x, y = _xy()
    sched1 = tlr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    eng1 = _linear(sched=sched1)
    for epoch in ckpt.train_epoch_range(4, str(tmp_path), eng1):
        eng1.train_batch(x, y)
        sched1.step()
        if epoch == 0:
            w_epoch0 = eng1.layer.weight.detach().clone()
        if epoch == 1:
            break
    sched2 = tlr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    eng2 = _linear(seed=5, sched=sched2)
    gen = ckpt.train_epoch_range(4, str(tmp_path), eng2)
    assert next(gen) == 1             # the restore runs on the first pull
    assert sched2() == 0.05
    # the layer's own parameter holds the restored value
    assert torch.equal(eng2.layer.weight, w_epoch0)
    assert eng2.state.params["weight"] is eng2.layer.weight
    gen.close()


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_simulated_preemption_checkpoints_and_resumes_bitwise(async_save,
                                                              tmp_path):
    """FLAGS_simulate_preempt_at_step 3: 3 epochs run, the emergency
    checkpoint and the marker land, PreemptedError; an engine of another
    seed resumes at epoch 3 and the 6 losses equal an uninterrupted
    run's bitwise (rtol 0, atol 0)."""
    x, y = _mlp_batch()
    ref = _losses(_mlp(seed=17), (x, y), 6)
    flags.set_flags({"FLAGS_simulate_preempt_at_step": 3})
    eng = _mlp(seed=17)
    losses = []
    before = _stat("preempt_emergency_saves")
    with pytest.raises(preempt.PreemptedError):
        for _ in ckpt.train_epoch_range(6, str(tmp_path), eng,
                                        async_save=async_save,
                                        max_to_keep=2):
            losses += _losses(eng, (x, y), 1)
    assert len(losses) == 3
    marker = str(tmp_path / "auto_ckpt" / preempt.MARKER_NAME)
    with open(marker) as f:
        assert json.load(f)["epoch"] == 2
    assert _stat("preempt_emergency_saves") - before == 1
    assert sorted(os.listdir(tmp_path / "auto_ckpt")) == \
        ["PREEMPTED", "ckpt-1", "ckpt-2"]

    flags.set_flags({"FLAGS_simulate_preempt_at_step": 0})
    preempt.clear()
    eng2 = _mlp(seed=999)
    resumed = []
    for epoch in ckpt.train_epoch_range(6, str(tmp_path), eng2,
                                        async_save=async_save):
        losses += _losses(eng2, (x, y), 1)
        resumed.append(epoch)
    assert resumed == [3, 4, 5], resumed
    assert not os.path.exists(marker)  # consumed on resume
    assert losses == ref


def test_train_epoch_range_refuses_a_layer(tmp_path):
    """A bare layer is refused with TypeError (no tolerance)."""
    with pytest.raises(TypeError):
        next(ckpt.train_epoch_range(2, str(tmp_path), _MLP()))


# -- persistables ---------------------------------------------------------------------


def test_persistables_round_trip(tmp_path):
    """A ResNet-18's parameters and BN stats, zeroed, come back bitwise;
    an engine's persistables restore its step and every leaf's sha256."""
    m = tresnet.resnet18(num_classes=4, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    ckpt.save_persistables(m, str(tmp_path / "p"))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with torch.no_grad():
        for v in m.state_dict().values():
            v.zero_()
    ckpt.load_persistables(m, str(tmp_path / "p"))
    after = m.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert "['bn1._mean']" in ckpt.load_manifest(str(tmp_path / "p"))

    eng = _mlp()
    _losses(eng, _mlp_batch(), 2)
    ckpt.save_persistables(eng, str(tmp_path / "e"))
    eng2 = _mlp(seed=8)
    ckpt.load_persistables(eng2, str(tmp_path / "e"))
    assert eng2.state.step == 2
    assert _payload_digests(eng2) == _payload_digests(eng)
