"""Port parity, model level: paddle_tpu_torch's ResNet family against
paddle_tpu's on the CPU, with the same numpy weights and running stats
moved through ``weights.from_paddle_tpu_values``. The reference runs its
default path (lax convs inside ``_conv_core`` / ``_conv_affine``), not
the Pallas interpret mode (``PADDLE_TPU_CONV_FORCE=pallas``).

- Eval logits of ``resnet18(num_classes=4)`` and a narrow bottleneck
  ``ResNet(BottleneckBlock, 50, width=16, num_classes=4)``, vanilla and
  space-to-depth stems, 2 x 3 x 32 x 32: within 1e-4 relative to the
  logits' scale.
- ``fold_conv7_stem``: the port's fold equals the reference's bit for
  bit, and a folded s2d model reproduces the vanilla one's logits.
- Training: ``Engine.train_batch`` of the s2d ResNet-18 and of the
  16-wide bottleneck with ``CrossEntropyLoss`` and Momentum (momentum
  0.9, coupled decay 1e-4, bench.py's optimizer at learning rate 1e-3:
  bench's 0.1 drives the loss of four images to exactly 0 in one step),
  f32, batch 4 x 3 x 64 x 64 (layer4's BN sees 16 values a channel; at
  2 x 3 x 32 x 32 it sees 2 and the reference moves its own logits by
  8e-3 for an input change of 1e-6). One step: the loss, and each
  parameter's and running stat's CHANGE over the step against the
  reference's, in L2 norm relative to that change's own norm (so a leaf
  with a small gradient is held as tightly as one with a large one).
  The tolerances are the reference's own spread (`STEP_LOSS_RTOL`,
  `DELTA_RTOL`): the gradient is discontinuous at every ReLU, and f32
  noise of 1e-6 flips the mask of an element whose pre-activation is
  ~5e-6 from 0. Planted faults (measured): a zeroed conv dx reads 1.0
  (57 of 102 and 156 of 267 leaves fail); dropping the 1e-4 decay reads
  1.01e-2 on one ResNet-18 leaf (fails, barely) and stays within the
  bottleneck's noise, so the coupled decay is held by
  tests/test_torch_fused_conv.py's Momentum test (decay 1e-2, rtol
  1e-6). Three ResNet-18 steps: the losses within `TRAJ_RTOL`.
- bf16 ``auto_cast``: the dtype of every block's activation equals the
  reference's, and an engine step gives a finite loss.
- The engine's anomaly guard keeps parameters, velocities and the BN
  running stats bit for bit on a poisoned batch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import engine as jengine
from paddle_tpu.engine import state_values
from paddle_tpu.vision.models import resnet as jresnet

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.ops import fused_conv as tfc
from paddle_tpu_torch.vision.models import resnet as tresnet

# The reference against itself, its input moved by 1e-6 (6 draws;
# `python tests/test_torch_resnet.py` measures it): the first loss moved
# by up to 4.8e-6 (ResNet-18) and 7.2e-5 (bottleneck) relative, a leaf's
# first-step change by up to 9.2e-3 and 0.174 of its own L2 norm, the
# later ResNet-18 losses by up to 3.7e-3 (1.83e-3 over 8 earlier draws)
# and the bottleneck's by 1.09: its trajectory is no witness, and only
# its first step is held.
STEP_LOSS_RTOL = {"resnet18": 1e-5, "bottleneck16": 8e-5}
DELTA_RTOL = {"resnet18": 1e-2, "bottleneck16": 0.2}
TRAJ_RTOL = 2e-3


def resnet_values(names_shapes, seed=0):
    """{name: f32 array}: He-scaled conv / fc weights, BN scales near 1,
    small biases, running means near 0 and variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        if name.endswith("_variance"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("_mean"):
            v = 0.1 * rng.randn(*shape)
        elif len(shape) >= 2:
            fan = np.prod(shape[1:]) if len(shape) == 4 else shape[0]
            v = rng.randn(*shape) * np.sqrt(2.0 / fan)
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        out[name] = v.astype(np.float32)
    return out


def _pair(make_j, make_t, seed=0):
    """(reference model, port model on the CPU, values) with the same
    weights and running stats."""
    paddle.seed(seed)
    jm = make_j()
    vals = resnet_values([(k, tuple(np.shape(v)))
                          for k, v in state_values(jm).items()], seed)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = make_t()
    weights.from_paddle_tpu_values(vals, tm)
    return jm, tm, vals


def _close(got, want, rtol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


MODELS = {
    "resnet18": (lambda s2d: jresnet.resnet18(num_classes=4,
                                              space_to_depth_stem=s2d),
                 lambda s2d: tresnet.resnet18(num_classes=4,
                                              space_to_depth_stem=s2d,
                                              device="cpu")),
    "bottleneck16": (
        lambda s2d: jresnet.ResNet(jresnet.BottleneckBlock, 50, width=16,
                                   num_classes=4, space_to_depth_stem=s2d),
        lambda s2d: tresnet.ResNet(tresnet.BottleneckBlock, 50, width=16,
                                   num_classes=4, space_to_depth_stem=s2d,
                                   device="cpu")),
}


@pytest.mark.parametrize("s2d", [False, True], ids=["vanilla", "s2d"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_logits_match_reference(name, s2d):
    make_j, make_t = MODELS[name]
    jm, tm, vals = _pair(lambda: make_j(s2d), lambda: make_t(s2d))
    assert len(vals) == len(tm.state_dict())
    if name == "resnet18":
        assert len(vals) == 102      # parameters and the BN buffers
    jm.eval()
    tm.eval()
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    ref = np.asarray(jm(paddle.to_tensor(x)).numpy())
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 4)
    _close(got, ref, 1e-4)


def test_fold_conv7_stem_round_trip():
    rng = np.random.RandomState(2)
    w7 = rng.randn(8, 3, 7, 7).astype(np.float32)
    w4 = tresnet.fold_conv7_stem(w7)
    assert np.array_equal(w4, jresnet.fold_conv7_stem(w7))
    conv7 = tnn.Conv2D(3, 8, 7, stride=2, padding=3, bias_attr=False)
    stem = tresnet.SpaceToDepthStem(3, 8)
    with torch.no_grad():
        conv7.weight.copy_(torch.from_numpy(w7))
        stem.conv.weight.copy_(torch.from_numpy(w4))
    for hw in (32, 31):              # even and odd inputs
        x = torch.from_numpy(rng.randn(2, 3, hw, hw).astype(np.float32))
        _close(stem(x), conv7(x).detach().numpy(), 1e-5)
    # a whole model: vanilla weights, the stem folded
    m7 = tresnet.resnet18(num_classes=4, device="cpu")
    ms = tresnet.resnet18(num_classes=4, space_to_depth_stem=True,
                          device="cpu")
    vals = resnet_values([(k, tuple(v.shape))
                          for k, v in m7.state_dict().items()], 3)
    weights.from_paddle_tpu_values(vals, m7)
    folded = dict(vals)
    folded["conv1.conv.weight"] = tresnet.fold_conv7_stem(
        folded.pop("conv1.weight"))
    weights.from_paddle_tpu_values(folded, ms)
    m7.eval()
    ms.eval()
    x = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
    _close(ms(x), m7(x).detach().numpy(), 2e-4)


# -- training against the reference engine ----------------------------------

BATCH = (4, 3, 64, 64)
STEPS = 3
TRAIN_MODELS = ("resnet18", "bottleneck16")


def _batch(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(*BATCH).astype(np.float32),
            rng.randint(0, 4, (BATCH[0],)).astype(np.int64))


def _opt_kwargs():
    return dict(learning_rate=0.001, momentum=0.9, weight_decay=1e-4)


def _snapshot(params, buffers):
    out = {k: np.array(np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v), np.float32) for k, v in params.items()}
    out.update({k: np.array(np.asarray(v), np.float32)
                for k, v in buffers.items()})
    return out


def _train(name, side, x, y, steps=STEPS):
    """`steps` engine steps of MODELS[name] (s2d stem) on one side ("j"
    the reference, "t" the port): the losses, and each parameter's and
    running stat's change over the first step (its value after the step
    less its initial value)."""
    make_j, make_t = MODELS[name]
    jm, tm, vals = _pair(lambda: make_j(True), lambda: make_t(True))
    if side == "j":
        crit = paddle.nn.CrossEntropyLoss()
        eng = jengine.Engine(jm, paddle.optimizer.Momentum(
            parameters=jm.parameters(), **_opt_kwargs()),
            lambda lg, yy: crit(lg, yy))
    else:
        crit = tnn.CrossEntropyLoss()
        eng = tengine.Engine(tm, topt.Momentum(parameters=tm.parameters(),
                                               **_opt_kwargs()),
                             lambda lg, yy: crit(lg, yy), device="cpu")
    losses, delta = [], None
    for i in range(steps):
        loss = eng.train_batch(x, y)
        losses.append(float(np.asarray(loss._value)) if side == "j"
                      else float(loss))
        if i == 0:
            snap = _snapshot(eng.state.params, eng.state.buffers)
            assert set(snap) == set(vals)
            delta = {k: snap[k] - vals[k] for k in vals}
    return losses, delta


def delta_err(got, want):
    """{leaf: |got - want| / |want|} of one step's changes, L2 norms
    over each leaf: each leaf against the scale of its own change."""
    return {k: float(np.linalg.norm(got[k] - want[k]) /
                     max(np.linalg.norm(want[k]), 1e-30)) for k in want}


def _both(name, steps):
    """Both engines, `steps` steps of one model on the same batch: the
    losses and the first step's changes."""
    x, y = _batch()
    out = {"name": name}
    for side in ("j", "t"):
        out[side], out[side + "1"] = _train(name, side, x, y, steps)
    return out


@pytest.fixture(scope="module")
def trained():
    return _both("resnet18", STEPS)


@pytest.fixture(scope="module")
def trained_bottleneck():
    return _both("bottleneck16", 1)


def _check_step(out):
    name = out["name"]
    np.testing.assert_allclose(out["t"][0], out["j"][0],
                               rtol=STEP_LOSS_RTOL[name])
    assert all(np.abs(d).max() > 0 for d in out["j1"].values())
    err = delta_err(out["t1"], out["j1"])
    bad = {k: e for k, e in err.items() if e > DELTA_RTOL[name]}
    assert not bad, (max(err.values()), bad)


def test_train_step_matches_reference_engine(trained):
    assert len(trained["j1"]) == 102
    _check_step(trained)


def test_bottleneck_train_step_matches_reference_engine(trained_bottleneck):
    _check_step(trained_bottleneck)


def test_three_step_trajectory_matches_reference(trained):
    assert all(np.isfinite(trained["t"]))
    np.testing.assert_allclose(trained["t"], trained["j"],
                               rtol=TRAJ_RTOL)


# -- bf16 auto_cast ----------------------------------------------------------


def _block_dtypes(model, register, run):
    """The output dtype of the stem's max pool, every block, the average
    pool and the fc layer, in call order. Hooks go on those modules
    only: a hooked conv or BN would leave the fused path."""
    seen = []
    mods = [model.maxpool]
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        mods += list(layer)
    mods += [model.avgpool, model.fc]
    for m in mods:
        register(m, lambda *a: seen.append(str(a[-1].dtype).split(".")[-1]))
    run()
    return seen


def test_bf16_auto_cast_dtypes_and_step():
    jm, tm, _ = _pair(lambda: jresnet.resnet18(num_classes=4,
                                               space_to_depth_stem=True),
                      lambda: tresnet.resnet18(num_classes=4,
                                               space_to_depth_stem=True,
                                               device="cpu"))
    x, y = _batch()

    def jrun():
        with jamp.auto_cast(enable=True, dtype="bfloat16"):
            jm(paddle.to_tensor(x))

    def trun():
        with tamp.auto_cast(enable=True, dtype="bfloat16"):
            tm(torch.from_numpy(x))

    jd = _block_dtypes(jm, lambda m, f: m.register_forward_post_hook(f),
                       jrun)
    td = _block_dtypes(tm, lambda m, f: m.register_forward_hook(f), trun)
    assert td == jd and td[0] == "bfloat16" and td[-1] == "float32"
    tm2 = tresnet.resnet18(num_classes=4, space_to_depth_stem=True,
                           device="cpu")
    teng = tengine.Engine(tm2, topt.Momentum(parameters=tm2.parameters(),
                                             **_opt_kwargs()),
                          lambda lg, yy: tnn.CrossEntropyLoss()(lg, yy),
                          device="cpu")
    with tamp.auto_cast(enable=True, dtype="bfloat16"):
        loss = teng.train_batch(x, y)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(p.dtype == torch.float32 for p in teng.state.params.values())


# -- the anomaly guard keeps the BN buffers ----------------------------------


def test_anomaly_guard_restores_bn_buffers():
    model = tresnet.resnet18(num_classes=4, space_to_depth_stem=True,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    eng = tengine.Engine(model, topt.Momentum(parameters=model.parameters(),
                                              **_opt_kwargs()),
                         lambda lg, y: tnn.CrossEntropyLoss()(lg, y),
                         device="cpu", anomaly_guard=True)
    x, y = _batch()
    eng.train_batch(x, y)
    assert eng.anomaly_bad_steps.item() == 0
    def state():
        bufs = {k: b for k, b in eng.state.buffers.items()
                if not k.startswith("__")}     # not the guard's counter
        return {**eng.state.params, **bufs,
                **{f"{k}.velocity": s["velocity"]
                   for k, s in eng.state.opt_state.items()}}

    before = {k: v.clone() for k, v in state().items()}
    assert "bn1._mean" in eng.state.buffers
    poisoned = x.copy()
    poisoned[0, 0, 5, 5] = np.inf
    launches = tfc.LAUNCHES
    loss = eng.train_batch(poisoned, y)
    assert not bool(torch.isfinite(loss))
    assert tfc.LAUNCHES == launches          # CPU: the plain version
    after = state()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert eng.anomaly_bad_steps.item() == 1
    # the forward did write the stats in place before the guard put them
    # back: a good step moves them again
    eng.train_batch(x, y)
    assert eng.anomaly_bad_steps.item() == 0
    assert not torch.equal(eng.state.buffers["bn1._mean"],
                           before["bn1._mean"])


# -- how the tolerances were measured ----------------------------------------


def _spread(name, draws, eps=1e-6):
    """The reference against itself, its input moved by `eps` (normal,
    `draws` seeds): the largest relative change of the first loss, of
    each later loss, and of a leaf's first-step change."""
    x, y = _batch()
    base = _train(name, "j", x, y)
    loss1 = traj = delta = 0.0
    for d in range(draws):
        xp = x + eps * np.random.RandomState(100 + d).randn(
            *x.shape).astype(np.float32)
        losses, step = _train(name, "j", xp, y)
        rel = np.abs(np.subtract(losses, base[0])) / np.abs(base[0])
        loss1, traj = max(loss1, rel[0]), max(traj, rel.max())
        delta = max(delta, max(delta_err(step, base[1]).values()))
    port = _train(name, "t", x, y)
    return dict(model=name, draws=draws, loss1=loss1, losses=traj,
                delta=delta, port_loss1=abs(port[0][0] - base[0][0]) /
                abs(base[0][0]),
                port_delta=max(delta_err(port[1], base[1]).values()))


def _chip_spread(draws, eps=1e-6):
    """chip_smoke.py's slice models on the port's CPU path against
    themselves, their input moved by `eps` (normal, `draws` seeds), and
    with every conv's dx zeroed (a planted fault): the largest relative
    change of the loss and of a leaf's first-step change."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    imgs, labels = cs._resnet_batch(4, 64, classes=4, seed=4)
    for depth, width in cs.SLICE_MODELS:
        def step(x):
            return cs.resnet_slice_step(depth, width, "cpu", x, labels)[1:3]

        loss, delta = step(imgs)
        loss_s = delta_s = 0.0
        for d in range(draws):
            xp = imgs + eps * np.random.RandomState(100 + d).randn(
                *imgs.shape).astype(np.float32)
            lp, dp = step(xp)
            loss_s = max(loss_s, abs(lp - loss) / abs(loss))
            delta_s = max(delta_s, cs.slice_delta_err(dp, delta)[0])
        orig = tfc._input_grad
        tfc._input_grad = lambda dz, w, cfg, xs: dz.new_zeros(xs)
        try:
            fault = cs.slice_delta_err(step(imgs)[1], delta)
        finally:
            tfc._input_grad = orig
        print(dict(model=f"depth {depth} width {width}", draws=draws,
                   loss=loss_s, delta=delta_s, dx_zeroed=fault), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_resnet.py: the spreads
    # behind STEP_LOSS_RTOL, DELTA_RTOL and TRAJ_RTOL; with `chip`, those
    # behind chip_smoke.py's SLICE_GATES
    import sys

    if sys.argv[1:] == ["chip"]:
        _chip_spread(draws=8)
    else:
        for model in TRAIN_MODELS:
            print(_spread(model, draws=6), flush=True)
