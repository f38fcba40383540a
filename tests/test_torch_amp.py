"""Port parity: mixed precision (paddle_tpu_torch.amp, the engine's and
hapi's amp paths, the float16 plain versions of the kernels) against
paddle_tpu on the same numpy inputs and weights, on the CPU.

* `GradScaler`, eager, side by side with the reference's: unscale then
  step without a second division, a second `unscale_` refused, a step
  skipped on inf (parameters untouched), the scale shrinking only after
  ``decr_every_n_nan_or_inf`` consecutive bad steps and growing after
  ``incr_every_n_steps`` good ones, `minimize`, and a `state_dict`
  round trip; every scale and parameter equal (exact: the same f32
  operations). `all_finite` and `amp_guard`.
* `decorate` O2: every parameter's and buffer's dtype the reference's
  (a tiny GPT, a conv + batch-norm net); O1 leaves them.
* Each optimizer rule on decorated bf16 and f16 parameters, given the
  same gradients, two eager steps: the parameters and the state after
  each step within one bf16 ulp, or 32 f16 ulps (`_ULPS`), in the
  reference's dtypes. Adam, AdamW, Lamb and LarsMomentum compute in f32
  and write back in the parameter's dtype; the other rules, as the
  reference's, in the parameter's dtype (their Python constants rounded
  to it, as jnp's weak types do). The reference's Adam-family, Lamb and
  Lars state starts as ``zeros_like(param)`` (16-bit) and is f32 from
  its first update on; the port's starts f32: the only dtype that
  differs, before any step, and zeros either way.
* One eager AdamW step of a decorated 2-layer GPT under O2: the loss
  within the low dtype's spread, then with the reference's gradients
  the parameters and the state as above.
* ``Engine(comm_dtype=)`` in bf16 and f16 on a 2-layer ERNIE: two steps'
  losses within rtol 2e-2 (bf16) / 2e-3 (f16), every parameter's change
  within 0.2 (bf16) / 0.05 (f16) of the reference's change (the form of
  tests/test_torch_ernie.py's bf16 trajectory criterion; O2 rounds every
  activation, so wider than its O1 0.1), parameters and AdamW moments
  f32.
* float16 O1 and O2 (``comm_dtype``) with dynamic loss scaling on the
  engine: the scale, good and bad step buffers over 4 steps (two
  overflowing, two going through) equal the reference's.
* hapi ``prepare(amp_configs={"level": "O2"})`` then `train_batch` on a
  tiny GPT: the loss within rtol 2e-2 of the reference's.
* In the ``comm_dtype`` and hapi O2 tests, every `amp.cast` of the step
  ran under O2 in the asked dtype and the residual adds took both
  operands in it (the loss and change limits alone would pass an f32
  step).
* The float16 plain versions of B1-B3 (against ``_flash_fwd_jnp`` /
  ``_flash_bwd_jnp``), B4-B6 (``_fwd_lax`` / ``_bwd_lax``) and B10 (the
  reference's lax conv with the fused op's epilogues) in float16, within
  rtol / atol 5e-3 (bf16's 2e-2 scaled by the two formats' epsilons;
  each package rounds to f16 at the same points).
* ``weights``: a decorated reference model's bf16 leaves load into the
  port bit for bit, and `to_numpy_values` returns bf16 leaves as exact
  float32.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.engine import Engine as JEngine

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.engine import Engine as TEngine
from torch_parity import VOCAB, build_ernie_pair, build_pair

def _np(t):
    """A tensor of either package as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    v = t._value if hasattr(t, "_value") else t
    return np.asarray(v.astype("float32"))


def _dtype(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    v = t._value if hasattr(t, "_value") else t
    return str(v.dtype)


# -- GradScaler --------------------------------------------------------------


def _linear_pair(seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 1).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    jl = paddle.nn.Linear(3, 1)
    jl.weight.set_value(paddle.to_tensor(w))
    jl.bias.set_value(paddle.to_tensor(b))
    from paddle_tpu_torch import nn as tnn

    tl = tnn.Linear(3, 1)
    tl.set_state_dict({"weight": w, "bias": b})
    return jl, tl


def _scaler_run(scaler_kw, batches, lr=0.1, unscale_first=False):
    """Both packages through ``scale(loss).backward(); [unscale_];
    step(opt)`` over `batches` (x arrays; an inf in x overflows the
    step). Returns, per step and package, (scale, weight, bias,
    grads)."""
    jl, tl = _linear_pair()
    jo = jopt.SGD(learning_rate=lr, parameters=jl.parameters())
    to = topt.SGD(learning_rate=lr, parameters=tl.parameters())
    js, ts = jamp.GradScaler(**scaler_kw), tamp.GradScaler(**scaler_kw)
    out = []
    for x in batches:
        jloss = jl(paddle.to_tensor(x)).sum()
        tloss = tl(torch.tensor(x)).sum()
        js.scale(jloss).backward()
        ts.scale(tloss).backward()
        if unscale_first:
            js.unscale_(jo)
            ts.unscale_(to)
        js.step(jo)
        ts.step(to)
        out.append(((float(np.asarray(js.get_loss_scaling()._value)),
                     _np(jl.weight), _np(jl.bias),
                     np.asarray(jl.weight._grad)),
                    (float(ts.get_loss_scaling()), _np(tl.weight),
                     _np(tl.bias), tl.weight.grad.numpy().copy())))
        jo.clear_grad()
        to.clear_grad()
    return out, (js, ts)


def _same(steps):
    for i, (want, got) in enumerate(steps):
        assert got[0] == want[0], (i, got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w, err_msg=f"step {i}")


GOOD = np.ones((2, 3), np.float32)
BAD = np.array([[1.0, np.inf, 1.0], [1.0, 1.0, 1.0]], np.float32)


def test_scaler_unscale_then_step_divides_once():
    steps, _ = _scaler_run(dict(init_loss_scaling=128.0), [GOOD, GOOD],
                           lr=0.0, unscale_first=True)
    _same(steps)
    # d sum(x w + b) / dw at x = 1: 2.0 each, unscaled exactly once
    for want, got in steps:
        np.testing.assert_array_equal(got[3], 2.0)


def test_scaler_refuses_a_second_unscale():
    jl, tl = _linear_pair()
    for mod, layer, scaler, t in (
            (jopt, jl, jamp.GradScaler(), paddle.to_tensor),
            (topt, tl, tamp.GradScaler(), torch.tensor)):
        opt = mod.SGD(learning_rate=0.1, parameters=layer.parameters())
        scaler.scale(layer(t(GOOD)).sum()).backward()
        scaler.unscale_(opt)
        with pytest.raises(RuntimeError, match="already been called"):
            scaler.unscale_(opt)


def test_scaler_skips_an_overflowing_step_and_shrinks():
    steps, _ = _scaler_run(dict(init_loss_scaling=1024.0),
                           [GOOD, BAD, GOOD])
    _same(steps)
    (_, w1, b1, _), (_, w2, b2, _) = steps[0][1], steps[1][1]
    np.testing.assert_array_equal(w2, w1)      # the bad step: no update
    np.testing.assert_array_equal(b2, b1)
    assert [s[1][0] for s in steps] == [1024.0, 512.0, 512.0]


def test_scaler_shrinks_only_after_consecutive_bad_steps():
    steps, _ = _scaler_run(dict(init_loss_scaling=1024.0,
                                decr_every_n_nan_or_inf=2),
                           [BAD, GOOD, BAD, BAD, BAD])
    _same(steps)
    assert [s[1][0] for s in steps] == [1024.0, 1024.0, 1024.0, 512.0,
                                        512.0]


def test_scaler_grows_after_good_steps():
    steps, _ = _scaler_run(dict(init_loss_scaling=8.0, incr_every_n_steps=2,
                                incr_ratio=4.0), [GOOD] * 5)
    _same(steps)
    assert [s[1][0] for s in steps] == [8.0, 32.0, 32.0, 128.0, 128.0]


def test_scaler_minimize_and_state_dict_round_trip():
    kw = dict(init_loss_scaling=64.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    _, (js, ts) = _scaler_run(kw, [GOOD, BAD, GOOD, GOOD])
    assert ts.state_dict() == js.state_dict()
    again = tamp.GradScaler(**kw)
    again.load_state_dict(ts.state_dict())
    assert again.state_dict() == ts.state_dict()
    # minimize steps as step does
    jl, tl = _linear_pair()
    for mod, layer, scaler, t in (
            (jopt, jl, js, paddle.to_tensor), (topt, tl, again,
                                               torch.tensor)):
        opt = mod.SGD(learning_rate=0.1, parameters=layer.parameters())
        scaled = scaler.scale(layer(t(GOOD)).sum())
        scaled.backward()
        scaler.minimize(opt, scaled)
    assert again.state_dict() == js.state_dict()
    np.testing.assert_array_equal(_np(tl.weight), _np(jl.weight))
    assert again.is_enable() and again.is_use_dynamic_loss_scaling()
    again.set_init_loss_scaling(2.0)
    assert float(again.get_loss_scaling()) == 2.0


def test_all_finite_and_amp_guard():
    ok = [torch.ones(3), torch.zeros(2, 2, dtype=torch.float16)]
    assert bool(tamp.all_finite(ok)) == bool(
        jamp.all_finite([np.ones(3), np.zeros((2, 2), np.float16)]))
    assert not bool(tamp.all_finite(ok + [torch.tensor([1.0, np.nan])]))
    assert not bool(tamp.all_finite({"a": {"b": torch.tensor([np.inf])}}))
    assert bool(tamp.all_finite([]))
    # queue C, C10: the parameter is named `tree`, as the reference's
    bad = {"x": torch.tensor([1.0, np.inf])}
    assert bool(tamp.all_finite(tree=bad)) == bool(
        jamp.all_finite(tree={"x": np.array([1.0, np.inf])})) is False
    assert bool(tamp.all_finite(tree=ok)) == bool(
        jamp.all_finite(tree=[np.ones(3)])) is True
    assert tamp.amp_guard is tamp.auto_cast
    with tamp.amp_guard(level="O2", dtype="float16"):
        assert tamp.policy()[0] == torch.float16
        assert tamp.policy()[3] == "O2"
    with pytest.raises(ValueError):
        with tamp.auto_cast(level="O3"):
            pass


# -- decorate ----------------------------------------------------------------


def _bn_net(mod):
    nn = mod.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3)
            self.bn = nn.BatchNorm2D(4)

        def forward(self, x):
            return self.bn(self.conv(x))

    return Net()


def _state_dtypes(model):
    return {k: _dtype(v) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_o2_casts_parameters_and_buffers(dtype):
    import paddle_tpu_torch as pt

    jm, tm, _ = build_pair()
    jn, tn = _bn_net(paddle), _bn_net(pt)
    for j, t in ((jm, tm), (jn, tn)):
        assert jamp.decorate(j, level="O1") is j
        assert tamp.decorate(t, level="O1") is t
        assert set(_state_dtypes(t).values()) == {"float32"}
        jo = jopt.Adam(parameters=j.parameters())
        to = topt.Adam(parameters=t.parameters())
        jr = jamp.decorate(j, jo, level="O2", dtype=dtype,
                           master_weight=True, save_dtype="float32")
        tr = tamp.decorate(t, to, level="O2", dtype=dtype,
                           master_weight=True, save_dtype="float32")
        assert tr[0] is t and tr[1] is to and jr[0] is j
        want = _state_dtypes(j)
        assert _state_dtypes(t) == {k: want[k] for k in _state_dtypes(t)}
        assert dtype in set(want.values())
    # the paddle attributes survive the cast (the same objects)
    assert tm.gpt.embeddings.word_embeddings.weight.name is not None
    tn.float()
    assert set(_state_dtypes(tn).values()) == {"float32"}
    tn.astype(dtype)
    assert set(_state_dtypes(tn).values()) == {dtype}


# -- optimizer rules on low-precision parameters -----------------------------

RULES = {
    "SGD": lambda m, P: m.SGD(0.1, parameters=P),
    "Momentum": lambda m, P: m.Momentum(0.1, momentum=0.9, parameters=P,
                                        use_nesterov=True),
    "Adam": lambda m, P: m.Adam(0.01, parameters=P),
    "AdamW": lambda m, P: m.AdamW(0.01, parameters=P, weight_decay=0.1),
    "Adamax": lambda m, P: m.Adamax(0.01, parameters=P),
    "Adagrad": lambda m, P: m.Adagrad(0.05, parameters=P,
                                      initial_accumulator_value=0.1),
    "Adadelta": lambda m, P: m.Adadelta(1.0, parameters=P, rho=0.9),
    "RMSProp": lambda m, P: m.RMSProp(0.01, parameters=P, centered=True,
                                      momentum=0.9),
    "LarsMomentum": lambda m, P: m.LarsMomentum(0.5, parameters=P,
                                                lars_weight_decay=0.01),
    "Lamb": lambda m, P: m.Lamb(0.01, parameters=P),
}


def _give_grads(jparams, tparams, grads):
    """The same gradient arrays, in each parameter's dtype, to both."""
    for jp, tp, g in zip(jparams, tparams, grads):
        jp._grad = paddle.to_tensor(g)._value.astype(jp._value.dtype)
        tp.grad = torch.tensor(g).to(tp.dtype)


def _opt_state(opt, params):
    out = {}
    for i, p in enumerate(params):
        for k, v in opt._accumulators.get(id(p), {}).items():
            out[f"{i}.{k}"] = v
    return out


_EPS = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11, "float32": 2.0 ** -24}


# (units in the last place allowed, the floor near 0 as a share of the
# largest element): bf16 rules agree to the last bit in practice (both
# round after every op, the constants rounded to bf16); XLA on the CPU
# evaluates a fused chain of f16 ops in f32 and rounds once where the
# port, as jnp's ops are defined, rounds after each op: up to a few
# f16 ulps of the tensor's larger elements, and a state carried over
# two steps (a momentum) compounds them; f32 (the Adam-family moments,
# Lars, Lamb): the ulps of a chain of f32 ops evaluated in another
# order, and of the norms Lars and Lamb sum in another order
_ULPS = {"bfloat16": (1, 2 ** -8), "float16": (32, 2 ** -2),
         "float32": (64, 2 ** -8)}


def _within_ulp(got, want, what):
    """|got - want| within `_ULPS` units in the last place of want's
    dtype, at the element's magnitude or at the floor near 0."""
    g, w = _np(got), _np(want)
    dt = _dtype(want)
    n, floor = _ULPS[dt]
    ulp = 2 * _EPS[dt] * n * np.maximum(np.abs(w), np.abs(w).max() * floor)
    err = np.abs(g - w)
    assert (err <= ulp).all(), (what, float((err / ulp).max()))


def _step_both(jo, to, jparams, tparams, grads):
    """One step of each optimizer on the same gradients: parameters and
    state within one ulp of their dtype. The reference's XLA evaluates
    each rule's elementwise chain in f32 and rounds at its outputs; the
    port writes each state tensor, then the parameter, rounding once
    each, so a state kept in the parameter's dtype can feed the update
    one rounding apart."""
    _give_grads(jparams, tparams, grads)
    jo.step()
    to.step()
    for i, (jp, tp) in enumerate(zip(jparams, tparams)):
        assert _dtype(tp) == _dtype(jp)
        _within_ulp(tp, jp, f"param {i}")
    want, got = _opt_state(jo, jparams), _opt_state(to, tparams)
    assert set(got) == set(want)
    for k in want:
        assert _dtype(got[k]) == _dtype(want[k]), k
        _within_ulp(got[k], want[k], k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_on_decorated_parameters_matches_reference(rule, dtype):
    from torch_parity import mlp_pair

    jm, tm = mlp_pair()
    jamp.decorate(jm, level="O2", dtype=dtype)
    tamp.decorate(tm, level="O2", dtype=dtype)
    jparams, tparams = list(jm.parameters()), list(tm.parameters())
    jo, to = RULES[rule](jopt, jparams), RULES[rule](topt, tparams)
    rng = np.random.RandomState(7)
    for _ in range(2):
        grads = [rng.randn(*p.shape).astype(np.float32) for p in tparams]
        _step_both(jo, to, jparams, tparams, grads)


@pytest.mark.parametrize("rule", ["Adam", "AdamW"])
def test_eager_step_of_a_decorated_gpt(rule):
    """The loss of a decorated 2-layer GPT under O2, then two steps of
    the rule on its bf16 parameters (the same gradients given to both:
    the reference's eager tape cannot take an O2 backward, its f32
    cotangents meet bf16 outputs)."""
    from paddle_tpu.nlp.transformers import GPTPretrainingCriterion as JC

    from paddle_tpu_torch.nlp.transformers import gpt as tgpt

    jm, tm, _ = build_pair()
    jo = RULES[rule](jopt, jm.parameters())
    to = RULES[rule](topt, tm.parameters())
    jamp.decorate(jm, jo, level="O2")
    tamp.decorate(tm, to, level="O2")
    ids = np.random.RandomState(1).randint(1, VOCAB, (2, 9)).astype(
        np.int64)
    x, y = ids[:, :-1], ids[:, 1:]
    with jamp.auto_cast(level="O2"):
        jloss = JC()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    with tamp.auto_cast(level="O2"):
        tloss = tgpt.GPTPretrainingCriterion()(tm(torch.tensor(x)),
                                               torch.tensor(y))
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()),
                               rtol=2e-2)
    jparams, tparams = list(jm.parameters()), list(tm.parameters())
    rng = np.random.RandomState(3)
    for _ in range(2):
        grads = [rng.randn(*p.shape).astype(np.float32) * 0.1
                 for p in tparams]
        _step_both(jo, to, jparams, tparams, grads)
        for p in tparams:
            assert p.dtype == torch.bfloat16


# -- the engine ---------------------------------------------------------------


def _ernie_engines(comm_dtype=None, loss_scale=None):
    from paddle_tpu.nlp.transformers import ErniePretrainingCriterion as JC

    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    jm, tm, vals = build_ernie_pair(seed=0)
    jc, tc = JC(), ternie.ErniePretrainingCriterion()
    jeng = JEngine(jm, jopt.AdamW(1e-3, parameters=jm.parameters(),
                                  weight_decay=0.01),
                   lambda out, mlm, nsp: jc(out[0], out[1], mlm, nsp),
                   comm_dtype=comm_dtype, loss_scale=loss_scale)
    teng = TEngine(tm, topt.AdamW(1e-3, parameters=tm.parameters(),
                                  weight_decay=0.01),
                   lambda out, mlm, nsp: tc(out[0], out[1], mlm, nsp),
                   device="cpu", comm_dtype=comm_dtype,
                   loss_scale=loss_scale)
    return jeng, teng, vals


def _ernie_batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    types = rng.randint(0, 2, (b, s)).astype(np.int32)
    mlm = ids.copy()
    mlm[rng.rand(b, s) > 0.3] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return (ids, types), (mlm, nsp)


@pytest.fixture
def casts(monkeypatch):
    """Every `amp.cast` the port makes while the test runs: (level, low
    dtype, op name, the dtypes it hands on)."""
    seen, cast = [], tamp.cast

    def rec(op_name, *tensors):
        out = cast(op_name, *tensors)
        st = tamp.policy()
        if st is not None:
            seen.append((st[3], st[0], op_name,
                         tuple(t.dtype for t in out
                               if isinstance(t, torch.Tensor))))
        return out

    monkeypatch.setattr(tamp, "cast", rec)
    return seen


def _assert_ran_o2(seen, dtype):
    """The step's forward ran under O2 in `dtype`: every cast saw that
    policy, and the residual adds (``elementwise_add``, on no list: O1
    and f32 leave them f32) took both operands in `dtype`."""
    low = getattr(torch, dtype)
    assert seen, "no op cast under auto_cast"
    assert {(level, d) for level, d, _, _ in seen} == {("O2", low)}
    adds = [dts for _, _, name, dts in seen if name == "elementwise_add"]
    assert adds and all(dts == (low, low) for dts in adds), adds


# (loss rtol, a parameter's change against the reference's change):
# AdamW's normalised step turns each gradient element's sign into +-lr,
# so elements whose gradient lies within the low dtype's rounding of 0
# step apart; bf16 rounds 8x coarser than f16
COMM = {"bfloat16": (2e-2, 0.2), "float16": (2e-3, 0.05)}


def _split_key_bias(name, a):
    """(the parameter without the key third of a qkv bias, that third or
    None)."""
    if not name.endswith("qkv_proj.bias"):
        return a, None
    h = a.shape[0] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


@pytest.mark.parametrize("dtype", sorted(COMM))
def test_engine_comm_dtype_matches_reference(dtype, casts):
    jeng, teng, vals = _ernie_engines(comm_dtype=dtype)
    inputs, labels = _ernie_batch()
    jl, tl = [], []
    for _ in range(2):
        jl.append(float(np.asarray(jeng.train_batch(inputs,
                                                    labels)._value)))
        tl.append(float(teng.train_batch(inputs, labels)))
    # the limits below alone would pass an f32 step (AdamW moves each
    # element by about +-lr whatever the gradient's precision)
    _assert_ran_o2(casts, dtype)
    loss_rtol, change = COMM[dtype]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    for k, v in jeng.state.params.items():
        got = teng.state.params[k]
        assert got.dtype == torch.float32
        (g, g_key), (w, w_key), (v0, _) = (
            _split_key_bias(k, a) for a in (got.detach().numpy(),
                                            np.asarray(v), vals[k]))
        moved = np.linalg.norm(w - v0)
        assert np.linalg.norm(g - w) <= change * moved, k
        if w_key is not None:
            # the key bias has no gradient (softmax ignores a row shift):
            # its Adam steps are +-lr of rounding noise in both packages
            assert np.abs(g_key - w_key).max() <= 2 * 1e-3 * 2 * 1.01, k
    for st in teng.state.opt_state.values():
        assert st["moment1"].dtype == torch.float32


def test_recompute_under_comm_dtype_replays_the_casts():
    """A recomputed block replays its first run's O2 casts: a GPT with
    recompute=True under comm_dtype bf16 takes the same steps as
    without recompute, bit for bit, and its losses follow the
    reference's recompute engine."""
    from paddle_tpu.nlp.transformers import GPTPretrainingCriterion as JC

    from paddle_tpu_torch.nlp.transformers import gpt as tgpt

    ids = np.random.RandomState(4).randint(0, VOCAB, (2, 17))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)
    runs = []
    for recompute in (False, True):
        jm, tm, _ = build_pair(recompute=recompute)
        jm.train()
        tm.train()
        teng = TEngine(tm, topt.AdamW(1e-3, parameters=tm.parameters()),
                       tgpt.GPTPretrainingCriterion(), device="cpu",
                       comm_dtype="bfloat16", seed=0)
        tl = [float(teng.train_batch(x, y)) for _ in range(2)]
        runs.append((tl, {k: p.detach().clone()
                          for k, p in teng.state.params.items()}))
        if recompute:
            jeng = JEngine(jm, jopt.AdamW(1e-3, parameters=jm.parameters()),
                           JC(), comm_dtype="bfloat16")
            jl = [float(np.asarray(jeng.train_batch(x, y)._value))
                  for _ in range(2)]
            np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_engine_float16_dynamic_loss_scale_follows_reference(level):
    """float16 with dynamic scaling on the engine, O1 under `auto_cast`
    and O2 through ``comm_dtype="float16"``: from 2^40 and then 2^20 the
    f16 backward overflows (the scale drops by 2^-20 each time), at 1
    the steps go through and the scale doubles after two; the scale,
    good and bad step buffers equal the reference's at each of 4 steps,
    and so do the losses."""
    from paddle_tpu.engine import BAD_STEPS_KEY, GOOD_STEPS_KEY, \
        LOSS_SCALE_KEY

    scale = {"init_loss_scaling": 2.0 ** 40, "decr_ratio": 2.0 ** -20,
             "incr_every_n_steps": 2, "decr_every_n_nan_or_inf": 1}
    o2 = level == "O2"
    jeng, teng, _ = _ernie_engines(loss_scale=scale,
                                   comm_dtype="float16" if o2 else None)
    inputs, labels = _ernie_batch()
    seen = []
    for i in range(4):
        with jamp.auto_cast(enable=not o2, dtype="float16"):
            jloss = jeng.train_batch(inputs, labels)
        with tamp.auto_cast(enable=not o2, dtype="float16"):
            tloss = teng.train_batch(inputs, labels)
        np.testing.assert_allclose(float(tloss),
                                   float(np.asarray(jloss._value)),
                                   rtol=2e-3)
        row = []
        for key in (LOSS_SCALE_KEY, GOOD_STEPS_KEY, BAD_STEPS_KEY):
            want = float(np.asarray(jeng.state.buffers[key]))
            got = float(teng.state.buffers[key])
            assert got == want, (i, key, got, want)
            row.append(got)
        seen.append(tuple(row))
    # two overflows, then two steps through (both levels)
    assert seen == [(2.0 ** 20, 0, 0), (1.0, 0, 0), (1.0, 1, 0),
                    (2.0, 0, 0)], seen


def test_hapi_o2_train_batch_matches_reference(casts):
    import paddle_tpu_torch as pt
    from paddle_tpu.nlp.transformers import GPTPretrainingCriterion as JC

    from paddle_tpu_torch.nlp.transformers import gpt as tgpt

    jm, tm, _ = build_pair()
    jmod = paddle.Model(jm).prepare(
        jopt.AdamW(1e-3, parameters=jm.parameters()), JC(),
        amp_configs={"level": "O2"})
    tmod = pt.Model(tm).prepare(
        topt.AdamW(1e-3, parameters=tm.parameters()),
        tgpt.GPTPretrainingCriterion(), amp_configs={"level": "O2"})
    ids = np.random.RandomState(2).randint(1, VOCAB, (2, 9)).astype(
        np.int64)
    for _ in range(2):
        want = jmod.train_batch([ids[:, :-1]], [ids[:, 1:]])
        got = tmod.train_batch([ids[:, :-1]], [ids[:, 1:]])
        np.testing.assert_allclose(got, want, rtol=2e-2)
    assert tmod._engine is not None and tmod._amp_level == "O2"
    _assert_ran_o2(casts, "bfloat16")


# -- float16 plain versions of the kernels -----------------------------------

F16_TOL = 5e-3


def test_flash_plain_versions_in_float16():
    import jax.numpy as jnp

    from paddle_tpu.ops import fused_ops as jfo

    from paddle_tpu_torch.ops import fused_ops as tfo

    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(4, 37, 64).astype(np.float16)
                   for _ in range(4))
    for causal in (False, True):
        o_w, lse_w = jfo._flash_fwd_jnp(*(jnp.asarray(t) for t in (q, k, v)),
                                        None, 0.125, causal, 0.0)
        o_g, lse_g = tfo._flash_fwd_plain(
            *(torch.tensor(t) for t in (q, k, v)), None, 0.125, causal, 0.0)
        assert o_g.dtype == torch.float16
        np.testing.assert_allclose(_np(o_g), _np(o_w), rtol=F16_TOL,
                                   atol=F16_TOL)
        np.testing.assert_allclose(lse_g.numpy(), np.asarray(lse_w),
                                   rtol=1e-5, atol=1e-5)
        want = jfo._flash_bwd_jnp(*(jnp.asarray(t) for t in (q, k, v)),
                                  o_w, lse_w, jnp.asarray(do), None, 0.125,
                                  causal, 0.0)
        got = tfo._flash_bwd_plain(
            *(torch.tensor(t) for t in (q, k, v)), o_g, lse_g,
            torch.tensor(do), None, 0.125, causal, 0.0)
        for g, w in zip(got, want):
            assert g.dtype == torch.float16
            np.testing.assert_allclose(_np(g), _np(w), rtol=F16_TOL,
                                       atol=F16_TOL)


def test_fused_loss_plain_versions_in_float16():
    import jax.numpy as jnp

    from paddle_tpu.ops import fused_loss as jfl

    from paddle_tpu_torch.ops import fused_loss as tfl

    rng = np.random.RandomState(1)
    x = (rng.randn(40, 64) * 0.5).astype(np.float16)
    w = (rng.randn(301, 64) * 0.1).astype(np.float16)
    lbl = rng.randint(0, 301, (40,)).astype(np.int32)
    lbl[::7] = -100
    g = np.full((40,), 2.0 ** 10 / 40, np.float32)   # a scaled mean
    nll_w, lse_w = jfl._fwd_lax(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(lbl), 128)
    nll_g, lse_g = tfl._fwd_plain(torch.tensor(x), torch.tensor(w),
                                  torch.tensor(lbl).long(), 128)
    np.testing.assert_allclose(lse_g.numpy(), np.asarray(lse_w), rtol=1e-5,
                               atol=1e-5)
    keep = lbl != -100
    np.testing.assert_allclose(nll_g.numpy()[keep], np.asarray(nll_w)[keep],
                               rtol=1e-5, atol=1e-5)
    dx_w, dw_w = jfl._bwd_lax(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(lbl), lse_w, jnp.asarray(g), 128)
    dx_g, dw_g = tfl._bwd_plain(torch.tensor(x), torch.tensor(w),
                                torch.tensor(lbl).long(), lse_g,
                                torch.tensor(g), 128)
    for got, want in ((dx_g, dx_w), (dw_g, dw_w)):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(_np(got), _np(want), rtol=F16_TOL,
                                   atol=F16_TOL)


@pytest.mark.parametrize("stride,epi", [(1, "moments"), (2, "affine")])
def test_fused_conv_plain_version_in_float16(stride, epi):
    import paddle_tpu.nn.functional as JF

    import paddle_tpu_torch.nn.functional as TF

    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 9, 9).astype(np.float16)
    w = (rng.randn(16, 8, 3, 3) / 8.0).astype(np.float16)
    g = (rng.rand(16) + 0.5).astype(np.float32)
    b = (rng.randn(16) * 0.1).astype(np.float32)
    mean, var = np.zeros(16, np.float32), np.ones(16, np.float32)
    train = epi == "moments"
    want = JF.fused_conv2d_bn_act(
        *(paddle.to_tensor(a) for a in (x, w, mean, var, g, b)),
        training=train, stride=stride, padding=1)
    got = TF.fused_conv2d_bn_act(
        *(torch.tensor(a) for a in (x, w, mean, var, g, b)),
        training=train, stride=stride, padding=1)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), _np(want), rtol=F16_TOL,
                               atol=F16_TOL * float(np.abs(_np(want)).max()))


def test_lowp_plain_version_takes_float16_operands():
    """Under float16 amp the reference hands B9 f16 activations (and,
    after `decorate`, f16 weights): the plain version quantises them
    from f16, int8 bit for bit the reference's lax path."""
    import jax.numpy as jnp

    from paddle_tpu.ops import lowp as jlowp

    from paddle_tpu_torch.ops import lowp as tlowp

    rng = np.random.RandomState(5)
    a = (rng.randn(9, 70) * 2).astype(np.float16)
    for b in ((rng.randn(70, 11) * 0.05).astype(np.float32),
              (rng.randn(70, 11) * 0.05).astype(np.float16)):
        sa = np.float32(np.abs(a.astype(np.float32)).max())
        sb = np.float32(np.abs(b.astype(np.float32)).max())
        want = np.asarray(jlowp._smm_lax(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(sa), jnp.asarray(sb),
                                         "int8"))
        got = tlowp._smm_plain(torch.tensor(a), torch.tensor(b),
                               torch.tensor(sa), torch.tensor(sb), "int8")
        np.testing.assert_array_equal(got.numpy(), want)


# -- weights -----------------------------------------------------------------


def test_decorated_reference_leaves_load_bit_for_bit():
    from paddle_tpu.engine import state_values

    jm, tm, _ = build_pair()
    jamp.decorate(jm, level="O2")
    vals = {k: np.asarray(v) for k, v in state_values(jm).items()}
    assert {a.dtype.name for a in vals.values()} == {"bfloat16"}
    tamp.decorate(tm, level="O2")
    weights.from_paddle_tpu_values(vals, tm)
    got = weights.to_numpy_values(tm)
    for k, v in vals.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.astype(np.float32))
