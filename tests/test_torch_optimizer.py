"""Port parity: paddle_tpu_torch's optimizer update and global-norm
clipping against paddle_tpu's compiled-engine path (``param_metas`` ->
``decay_gradients_tree`` -> ``ClipGradByGlobalNorm._clip_fn`` ->
``apply_gradients_tree``), on the same numpy parameters and gradients
over 4 steps.

The update is elementwise float32 arithmetic in the same order on both
sides; the only sum is the clipper's global norm (summed in another
order), so parameters and moments agree within rtol 1e-6 (atol 1e-7
for entries near 0).

The 14 LR schedulers of ``optimizer.lr`` are the reference's own
Python arithmetic: their rates over 30 steps and their ``state_dict``
round trip (either way across the packages) are equal exactly. The
engine's loss scaling (static, dynamic, a dict of GradScaler knobs)
and anomaly guard run a small model for 4 steps beside the
reference's ``Engine``: the second on a batch poisoned with inf (loss
and gradients non-finite), the third with a NaN loss term that no
parameter reaches (finite gradients: loss scaling keeps the update,
the guard skips it). Losses, parameters and moments agree within rtol
1e-6; a skipped step leaves the parameters bit for bit as they were;
the scale, its counters and the guard's counter equal the reference's
after every step. A frozen weight (``stop_gradient`` in the reference,
``requires_grad`` False in the port) rides with the buffers in both:
one AdamW step with decay leaves it bit for bit and gives it no
optimizer state, while the trainable leaves match within rtol 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import engine as jengine
from paddle_tpu.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.clip import ClipGradByGlobalNorm as TClip
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "norm.weight": (5,)}
STEPS, LR = 4, 0.05


def _no_decay(name):
    return not (name.endswith("bias") or "norm" in name)


def _opts(kind):
    if kind == "adam_l2":          # coupled L2 decay, folded in pre-clip
        return (paddle.optimizer.Adam(learning_rate=LR, weight_decay=0.1),
                topt.Adam(learning_rate=LR, weight_decay=0.1))
    return (paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.1,
                                   apply_decay_param_fun=_no_decay),
            topt.AdamW(learning_rate=LR, weight_decay=0.1,
                       apply_decay_param_fun=_no_decay))


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("kind", ["adam_l2", "adamw_selective"])
def test_update_matches_reference_engine_path(kind, clip):
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    jopt, topt_ = _opts(kind)
    # the reference resolves decay per Parameter by its name
    jmetas = jopt.param_metas({k: JParameter(jnp.asarray(v), name=k)
                               for k, v in p0.items()})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = {k: jopt._init_state(v) for k, v in jp.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    tst = {k: topt_._init_state(v) for k, v in tp.items()}
    tmetas = {k: topt_._leaf_meta(k) for k in tp}
    lr = torch.tensor(LR)
    for g in grads:
        jg = jopt.decay_gradients_tree(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jmetas)
        tg = topt_.decay_gradients(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tmetas)
        if clip is not None:
            jg, tg = JClip(clip)._clip_fn(jg), TClip(clip)._clip_fn(tg)
        jp, jst = jopt.apply_gradients_tree(jp, jg, jst,
                                            jnp.asarray(LR, jnp.float32),
                                            metas=jmetas)
        topt_.apply_gradients(tp, tg, tst, lr, tmetas)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for name, v in jst[k].items():
            np.testing.assert_allclose(tst[k][name].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k}.{name}")
    # apply_decay_param_fun / coupled decay really changed something
    assert ("decoupled_coeff" in tmetas["fc.bias"]) == (kind != "adam_l2")


# each scheduler built the same way in either package's `lr` module
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=1.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.1, decay_steps=10, end_lr=0.001, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=10), warmup_steps=5, start_lr=0.0,
        end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [3, 7, 20], gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=4, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=12, eta_min=0.001),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1),
    "OneCycleLR": lambda m: m.OneCycleLR(max_learning_rate=0.1,
                                         total_steps=30),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     mode="triangular2"),
}
# ReduceOnPlateau's metric: falling, then two plateaus
_METRICS = [5.0 - 0.3 * min(i, 8) + (0.01 if i % 3 else 0.0)
            for i in range(40)]


def _walk(sched, steps, start=0, as_tensor=False):
    rates = []
    for i in range(start, start + steps):
        rates.append(sched())
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            m = _METRICS[i]
            sched.step(torch.tensor(m, dtype=torch.float64) if as_tensor
                       else m)
        else:
            sched.step()
    return rates


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_reference(name):
    assert len(SCHEDULERS) == 14
    make = SCHEDULERS[name]
    js, ts = make(jlr), make(tlr)
    assert type(ts).__name__ == type(js).__name__ == name
    assert _walk(ts, 30, as_tensor=True) == _walk(js, 30)
    assert ts.state_dict() == js.state_dict()
    # state_dict round trip, both ways, then both continue alike
    tr, jr = make(tlr), make(jlr)
    tr.set_state_dict(js.state_dict())
    jr.set_state_dict(ts.state_dict())
    assert _walk(tr, 5, 30) == _walk(jr, 5, 30) == _walk(js, 5, 30)
    # an optimizer reads the scheduler's current rate
    assert topt.AdamW(learning_rate=ts).get_lr() == float(ts())


class _JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(x)


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(4, 3)

    def forward(self, x):
        return self.fc(x)


def _batches():
    rng = np.random.RandomState(5)
    out = []
    for i in range(4):
        x = rng.randn(8, 4).astype(np.float32)
        z = np.zeros((2,), np.float32)
        if i == 1:
            x[3, 2] = np.inf            # the poisoned batch
        if i == 2:
            z[1] = np.nan               # a NaN loss, finite gradients
        out.append((x, rng.randn(8, 3).astype(np.float32), z))
    return out


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), what
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                               err_msg=what)


@pytest.mark.parametrize("loss_scale,guard", [
    (128.0, False), ("dynamic", False),
    ({"init_loss_scaling": 1024.0, "incr_every_n_steps": 2,
      "decr_every_n_nan_or_inf": 1}, True),
    (None, True)], ids=["static", "dynamic", "dict_guarded", "guard_only"])
def test_engine_loss_scale_and_anomaly_guard_match_reference(loss_scale,
                                                             guard):
    rng = np.random.RandomState(0)
    vals = {"fc.weight": rng.randn(4, 3).astype(np.float32),
            "fc.bias": rng.randn(3).astype(np.float32)}
    jm = _JNet()
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = _TNet()
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in vals.items()})
    jsched, tsched = (m.StepDecay(0.05, step_size=2, gamma=0.5)
                      for m in (jlr, tlr))
    jopt = paddle.optimizer.AdamW(learning_rate=jsched,
                                  parameters=jm.parameters())
    topt_ = topt.AdamW(learning_rate=tsched)
    jeng = jengine.Engine(
        jm, jopt,
        lambda out, y, z: paddle.mean((out - y) * (out - y)) + paddle.sum(z),
        grad_clip=JClip(1.0), loss_scale=loss_scale, anomaly_guard=guard)
    teng = tengine.Engine(
        tm, topt_, lambda out, y, z: ((out - y) * (out - y)).mean() + z.sum(),
        grad_clip=TClip(1.0), loss_scale=loss_scale, anomaly_guard=guard,
        device="cpu")
    keys = [k for k in (tengine.LOSS_SCALE_KEY, tengine.GOOD_STEPS_KEY,
                        tengine.BAD_STEPS_KEY, tengine.ANOMALY_BAD_STEPS_KEY)
            if k in jeng.state.buffers]
    assert sorted(keys) == sorted(k for k in teng.state.buffers)
    for i, (x, y, z) in enumerate(_batches()):
        before = {k: p.detach().clone() for k, p in teng.state.params.items()}
        jloss = np.asarray(jeng.train_batch(x, (y, z))._value)
        tloss = teng.train_batch(x, (y, z)).numpy()
        jsched.step()
        tsched.step()
        _close(tloss, jloss, f"loss {i}")
        for k, v in jeng.state.params.items():
            _close(teng.state.params[k].detach().numpy(), v, f"{k} {i}")
            for n, a in jeng.state.opt_state[k].items():
                _close(teng.state.opt_state[k][n].numpy(), a, f"{k}.{n} {i}")
        for k in keys:
            assert teng.state.buffers[k].item() == \
                np.asarray(jeng.state.buffers[k]).item(), (k, i)
        if i == 1 or (i == 2 and guard):   # skipped: nothing changed
            assert not np.isfinite(tloss)
            for k, p in teng.state.params.items():
                assert torch.equal(p.detach(), before[k]), k
        elif i == 2:
            assert not all(torch.equal(p.detach(), before[k])
                           for k, p in teng.state.params.items())
    if guard:
        assert teng.anomaly_bad_steps.item() == 0
    if isinstance(loss_scale, dict):
        # 1024 -> 512 on the bad step -> 1024 after two good ones
        assert teng.state.buffers[tengine.LOSS_SCALE_KEY].item() == 1024.0


def test_engine_leaves_a_frozen_parameter_alone():
    # the reference's param_values skips stop_gradient parameters: no
    # optimizer state, no decay, no update; the port's counterpart of
    # the flag is requires_grad
    rng = np.random.RandomState(7)
    jm = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                              paddle.nn.Linear(32, 4))
    vals = {k: rng.randn(*v.shape).astype(np.float32) * 0.3
            for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    jm[0].weight.stop_gradient = True
    tm = tnn.Sequential(tnn.Linear(16, 32), tnn.ReLU(), tnn.Linear(32, 4))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in vals.items()})
    tm[0].weight.requires_grad_(False)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.int64)
    jeng = jengine.Engine(
        jm, paddle.optimizer.AdamW(0.1, parameters=jm.parameters(),
                                   weight_decay=0.5),
        paddle.nn.CrossEntropyLoss())
    teng = tengine.Engine(tm, topt.AdamW(0.1, weight_decay=0.5),
                          tnn.CrossEntropyLoss(), device="cpu")
    jeng.train_batch(x, y)
    teng.train_batch(x, y)
    frozen = "0.weight"
    for st in (jeng.state, teng.state):
        assert frozen not in st.params and frozen not in st.opt_state
        assert frozen in st.buffers
    np.testing.assert_array_equal(np.asarray(jeng.state.buffers[frozen]),
                                  vals[frozen])
    np.testing.assert_array_equal(teng.state.buffers[frozen].numpy(),
                                  vals[frozen])
    assert teng.state.buffers[frozen] is tm[0].weight
    assert sorted(teng.state.params) == sorted(jeng.state.params)
    for k, v in jeng.state.params.items():
        assert not np.array_equal(np.asarray(v), vals[k]), k
        np.testing.assert_allclose(teng.state.params[k].detach().numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        for n, a in jeng.state.opt_state[k].items():
            np.testing.assert_allclose(teng.state.opt_state[k][n].numpy(),
                                       np.asarray(a), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k}.{n}")
