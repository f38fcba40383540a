"""Port parity: the optimizers of paddle_tpu_torch against paddle_tpu's on a
2-layer MLP (8 -> 16 -> 4) with the same numpy weights and batches.

* Every rule takes 3 steps through each package's ``Engine``; the losses
  and every parameter agree within rtol 1e-5 / atol 1e-6 (f32: the
  products and the norms of LARS / Lamb are summed in other orders).
* Parameter groups, `ParamAttr` learning-rate multipliers and
  regularizers (L1 and L2, the parameter's winning over the
  optimizer's), ``AdamW(lr_ratio=)`` and the LARS / Lamb exclusions go
  through the same 3 Engine steps. Both packages name parameters the
  same way (``linear_0.bias``), so a name-based exclusion hits the same
  leaves: both automatic-name counters are reset before the models are
  built.
* The eager API (``loss.backward(); opt.step(); opt.clear_grad()``)
  against the reference's eager ``step``, with coupled decay (the
  reference's eager path adds ``coeff * p`` under L1Decay too) and
  clipping; the optimizer's ``state_dict`` has the reference's keys and
  values, and ``set_state_dict`` of the reference's state continues
  the reference's trajectory.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.clip import ClipGradByGlobalNorm as JGlobal
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.param_attr import ParamAttr as JParamAttr
from paddle_tpu.regularizer import L1Decay as JL1
from paddle_tpu.regularizer import L2Decay as JL2

from paddle_tpu_torch import ParamAttr as TParamAttr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.clip import ClipGradByGlobalNorm as TGlobal
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.regularizer import L1Decay as TL1
from paddle_tpu_torch.regularizer import L2Decay as TL2
from torch_parity import mlp_batches as _batches
from torch_parity import mlp_mse as _mse
from torch_parity import mlp_pair as _pair
from torch_parity import mlp_values as _values

RTOL, ATOL = 1e-5, 1e-6
STEPS = 3


def _engine_run(jm, tm, jo, to, jclip=None, tclip=None):
    jeng = JEngine(jm, jo, _mse, grad_clip=jclip)
    teng = TEngine(tm, to, _mse, grad_clip=tclip, device="cpu")
    for x, y in _batches():
        jl = float(np.asarray(jeng.train_batch((x,), (y,))._value))
        tl = float(teng.train_batch((x,), (y,)))
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    want = {k: np.asarray(v) for k, v in jeng.state.params.items()}
    got = {k: p.detach().numpy() for k, p in teng.state.params.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        # the update really moved the parameter
        assert not np.array_equal(want[k], _values()[k]), k
    return jeng, teng


RULES = {
    "SGD": (lambda m, P: m.SGD(0.1, parameters=P), {}),
    "Momentum": (lambda m, P: m.Momentum(0.1, momentum=0.9, parameters=P,
                                         use_nesterov=True), {}),
    "Adam": (lambda m, P: m.Adam(0.01, parameters=P), {}),
    "AdamW": (lambda m, P: m.AdamW(0.01, parameters=P, weight_decay=0.1),
              {}),
    "Adamax": (lambda m, P: m.Adamax(0.01, parameters=P), {}),
    "Adagrad": (lambda m, P: m.Adagrad(0.05, parameters=P,
                                       initial_accumulator_value=0.1), {}),
    "Adadelta": (lambda m, P: m.Adadelta(1.0, parameters=P, rho=0.9), {}),
    "RMSProp": (lambda m, P: m.RMSProp(0.01, parameters=P), {}),
    "RMSProp_centered_momentum": (lambda m, P: m.RMSProp(
        0.01, parameters=P, centered=True, momentum=0.9), {}),
    "LarsMomentum": (lambda m, P: m.LarsMomentum(
        0.5, parameters=P, lars_weight_decay=0.01), {}),
    "Lamb": (lambda m, P: m.Lamb(0.01, parameters=P), {}),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_three_engine_steps_match_reference(rule):
    make, _ = RULES[rule]
    jm, tm = _pair()
    _engine_run(jm, tm, make(jopt, jm.parameters()),
                make(topt, tm.parameters()))


def _attr_case(case):
    """(reference attrs, port attrs, optimizer factory) of one
    per-parameter case."""
    if case == "paramattr_lr_l1":
        ja = {"w1": JParamAttr(learning_rate=0.5,
                                     regularizer=JL1(0.05)),
              "b2": JParamAttr(regularizer=JL2(0.2))}
        ta = {"w1": TParamAttr(learning_rate=0.5, regularizer=TL1(0.05)),
              "b2": TParamAttr(regularizer=TL2(0.2))}
        return ja, ta, lambda m, P: m.Adam(0.01, parameters=P,
                                           weight_decay=0.01)
    if case == "optimizer_l1":
        return None, None, lambda m, P: m.Momentum(
            0.1, parameters=P, weight_decay=(JL1 if m is jopt else TL1)(0.05))
    if case == "param_groups":
        def make(m, P):
            P = list(P)
            return m.Adam(0.01, weight_decay=0.01, parameters=[
                {"params": P[:2], "learning_rate": 2.0},
                {"params": P[2:], "weight_decay": 0.3}])
        return None, None, make
    if case == "adamw_lr_ratio":
        return None, None, lambda m, P: m.AdamW(
            0.01, parameters=P, weight_decay=0.1, lr_ratio=lambda p: 0.1,
            apply_decay_param_fun=lambda n: not n.endswith("bias"))
    if case == "lars_exclude":
        return None, None, lambda m, P: m.LarsMomentum(
            0.5, parameters=P, lars_weight_decay=0.1,
            exclude_from_weight_decay=["bias", "linear_1"])
    if case == "lamb_exclude_fn":
        return None, None, lambda m, P: m.Lamb(
            0.01, parameters=P, lamb_weight_decay=0.1,
            exclude_from_weight_decay_fn=lambda p: True)
    raise KeyError(case)


CASES = ["paramattr_lr_l1", "optimizer_l1", "param_groups",
         "adamw_lr_ratio", "lars_exclude", "lamb_exclude_fn"]


@pytest.mark.parametrize("case", CASES)
def test_per_parameter_attributes_match_reference(case):
    ja, ta, make = _attr_case(case)
    jm, tm = _pair(ja, ta)
    _engine_run(jm, tm, make(jopt, jm.parameters()),
                make(topt, tm.parameters()))


def test_paramattr_lands_on_the_parameter():
    attr = TParamAttr(name="w", learning_rate=0.5, regularizer=TL1(0.1),
                      trainable=False, need_clip=False)
    lin = tnn.Linear(3, 2, weight_attr=attr, bias_attr=False)
    w = lin.weight
    assert (w.name, w.optimize_attr, w.need_clip, w.requires_grad,
            lin.bias) == ("w", {"learning_rate": 0.5}, False, False, None)
    assert isinstance(w.regularizer, TL1)
    meta = topt.Adam(0.1, weight_decay=0.01)._leaf_meta(w)
    assert meta == {"coeff": 0.1, "l1": True, "lr_mult": 0.5}


def _eager_run(jm, tm, jo, to, steps=STEPS):
    for x, y in _batches(steps):
        jl = _mse(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jo.step()
        jo.clear_grad()
        tl = _mse(tm(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(float(tl), float(np.asarray(jl._value)),
                                   rtol=RTOL, atol=ATOL)
        assert all(p.grad is None for p in tm.parameters())
    for (k, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(
            jp._value), rtol=RTOL, atol=ATOL, err_msg=k)


EAGER = {
    "adam_l1": lambda m, P: m.Adam(
        0.01, parameters=P, weight_decay=(JL1 if m is jopt else TL1)(0.05)),
    "adamw_clip": lambda m, P: m.AdamW(
        0.01, parameters=P, weight_decay=0.1,
        grad_clip=(JGlobal if m is jopt else TGlobal)(0.5)),
    "momentum_l2": lambda m, P: m.Momentum(0.1, parameters=P,
                                           weight_decay=0.01),
    "rmsprop": lambda m, P: m.RMSProp(0.01, parameters=P, centered=True),
    "lamb": lambda m, P: m.Lamb(0.01, parameters=P),
}


@pytest.mark.parametrize("case", sorted(EAGER))
def test_eager_step_matches_reference(case):
    jm, tm = _pair()
    _eager_run(jm, tm, EAGER[case](jopt, jm.parameters()),
               EAGER[case](topt, tm.parameters()))


def test_eager_minimize_and_attrs_match_reference():
    ja = {"w1": JParamAttr(learning_rate=0.25, regularizer=JL2(0.1))}
    ta = {"w1": TParamAttr(learning_rate=0.25, regularizer=TL2(0.1))}
    jm, tm = _pair(ja, ta)
    jo = jopt.SGD(0.1, parameters=jm.parameters(), weight_decay=0.01)
    to = topt.SGD(0.1, parameters=tm.parameters(), weight_decay=0.01)
    x, y = _batches(1)[0]
    _mse(jm(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
    jo.minimize(None)
    tloss = _mse(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    _, pairs = to.minimize(tloss)
    assert len(pairs) == 4
    for (k, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(
            jp._value), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("rule", ["Adam", "Momentum", "Adamax"])
def test_state_dict_keys_values_and_round_trip(rule):
    make, _ = RULES[rule]
    jm, tm = _pair()
    sched = (paddle.optimizer.lr.StepDecay(0.01, step_size=2),
             topt.lr.StepDecay(0.01, step_size=2))
    jo = make(jopt, jm.parameters())
    to = make(topt, tm.parameters())
    jo._learning_rate, to._learning_rate = sched
    _eager_run(jm, tm, jo, to, steps=2)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert sorted(tsd) == sorted(jsd)
    assert tsd["global_step"] == jsd["global_step"] == 2
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k in jsd:
        if k not in ("global_step", "LR_Scheduler"):
            np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            assert tsd[k].shape == np.asarray(jsd[k]).shape, k
    # a fresh port optimizer takes the reference's state and continues
    # its trajectory
    to2 = make(topt, tm.parameters())
    to2._learning_rate = topt.lr.StepDecay(0.01, step_size=2)
    to2.set_state_dict({k: (np.asarray(v) if k not in (
        "global_step", "LR_Scheduler") else v) for k, v in jsd.items()})
    assert to2._global_step == 2
    assert to2._learning_rate.last_epoch == jo._learning_rate.last_epoch
    _eager_run(jm, tm, jo, to2, steps=1)
    assert sorted(to2.state_dict()) == sorted(jo.state_dict())
