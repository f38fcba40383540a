"""Port parity: the layer classes of paddle_tpu_torch.nn against
paddle_tpu's (tests/torch_nn_cases.py), the initializers, nn.utils and
the weights' boundary.

* One case per layer class (activations, common, conv, norm, pooling,
  losses, containers): the same state names and shapes in both packages,
  the same random numpy values loaded into both, and the outputs and the
  state after the call within rtol 1e-5 / atol 1e-6 (atol 1e-5 where the
  case sums 64 or more terms); for a layer with parameters also the
  gradients of the inputs and of every parameter, by name (a layer
  without parameters differentiates as its functional op, held to the
  reference in test_torch_nn_functional.py). The Transformer and RNN
  classes have their own files (test_torch_transformer.py,
  test_torch_rnn_decode.py).
* Coverage: every class of the reference's nn exists in the port and has
  a case (or a named reason), bar the waiting set.
* Containers name their children as the reference does (``layers.<i>``).
* Initializers: each draws from its explicit generator with the
  reference's fans and bounds.
* nn.utils: weight_norm / remove_weight_norm / spectral_norm against the
  reference on the same weights (names, forward, gradients, the power
  iteration's vectors).
* ``weights.from_paddle_tpu_values`` carries a reference state into a
  port model by name (weight norm's g / v, spectral norm's vectors).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.engine import state_values

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.nn import initializer as I
from torch_nn_cases import L_CASES, NOT_SWEPT, WAITING
from torch_nn_parity import assert_same, check_layer_case, layer_pair, \
    run_port, run_ref, to_np

_OWN_FILES = {"MultiHeadAttention", "TransformerEncoderLayer",
              "TransformerEncoder", "TransformerDecoderLayer",
              "TransformerDecoder", "Transformer", "SimpleRNNCell",
              "LSTMCell", "GRUCell", "RNN", "BiRNN", "SimpleRNN", "LSTM",
              "GRU"}


@pytest.mark.parametrize(
    "case", [c for c in L_CASES if c.fn not in _OWN_FILES],
    ids=lambda c: c.id)
def test_layer_parity(case):
    check_layer_case(case)


def test_every_reference_class_exists_and_has_a_case():
    ref = {n for n in vars(jnn) if not n.startswith("_")
           and n not in ("functional", "initializer", "layer", "utils",
                         "loss")}
    port = {n for n in vars(tnn) if not n.startswith("_")}
    assert ref - port == set(WAITING)
    covered = {c.fn for c in L_CASES} | set(NOT_SWEPT)
    assert ref - covered == set(WAITING)


def test_containers_name_children_like_the_reference():
    for ctor in (lambda nn: nn.LayerList([nn.Linear(3, 2), nn.Linear(2, 2)]),
                 lambda nn: nn.LayerDict({"p": nn.Linear(3, 2)}),
                 lambda nn: nn.ParameterList(
                     [nn.Linear(3, 2).weight, nn.Linear(2, 2).bias])):
        jm, tm, _ = layer_pair(ctor)
        assert list(tm.state_dict()) == list(jm.state_dict())
    lst = tnn.LayerList([tnn.Linear(3, 2)])
    lst.append(tnn.ReLU()).extend([tnn.Tanh()])
    lst.insert(1, tnn.Sigmoid())
    assert [type(m).__name__ for m in lst] == ["Linear", "Sigmoid", "ReLU",
                                               "Tanh"]
    assert isinstance(lst[-1], tnn.Tanh) and len(lst[1:3]) == 2
    d = tnn.LayerDict({"a": tnn.ReLU()})
    d["b"] = tnn.Tanh()
    assert list(d.keys()) == ["a", "b"] and "b" in d
    del d["a"]
    assert len(d) == 1
    pl = tnn.ParameterList([tnn.Linear(2, 2).weight])
    pl.append(tnn.Linear(2, 3).bias)
    assert [tuple(p.shape) for p in pl] == [(2, 2), (3,)]


# -- initializers ------------------------------------------------------------


def _draw(init, shape, seed=0):
    return init(shape, torch.Generator().manual_seed(seed))


def test_initializers_draw_from_their_generator():
    for init in (I.TruncatedNormal(0.5, 2.0), I.XavierUniform(),
                 I.KaimingNormal(), I.Orthogonal(), I.Normal(), I.Uniform(),
                 I.XavierNormal(), I.KaimingUniform()):
        a, b = _draw(init, [64, 48]), _draw(init, [64, 48])
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert not torch.equal(a, _draw(init, [64, 48], seed=1))


def test_initializer_distributions():
    t = _draw(I.TruncatedNormal(0.5, 2.0), [200, 300])
    assert float(t.min()) >= 0.5 - 4.0 - 1e-5
    assert float(t.max()) <= 0.5 + 4.0 + 1e-5
    assert abs(float(t.mean()) - 0.5) < 0.03
    # the reference's fans: a conv weight [out, in, kh, kw]
    shape = [16, 8, 3, 3]
    fan_in, fan_out = 8 * 9, 16 * 9
    xu = _draw(I.XavierUniform(), shape)
    assert float(xu.abs().max()) <= math.sqrt(6 / (fan_in + fan_out))
    kn = _draw(I.KaimingNormal(), [64, 32, 3, 3])
    assert abs(float(kn.std()) - math.sqrt(2 / (32 * 9))) < 0.01
    xn = _draw(I.XavierNormal(gain=2.0), [300, 500])
    assert abs(float(xn.std()) - 2 * math.sqrt(2 / 800)) < 0.002
    a = I.Assign(np.arange(6, dtype=np.float32))([2, 3])
    assert torch.equal(a, torch.arange(6.0).reshape(2, 3))
    for shape in ([8, 5], [5, 8], [4, 3, 6]):
        q = _draw(I.Orthogonal(gain=1.5), shape).reshape(-1, shape[-1])
        g = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
        torch.testing.assert_close(g, 2.25 * torch.eye(g.shape[0]),
                                   atol=1e-5, rtol=0)
    want = np.asarray(jnn.initializer.Dirac(groups=2)([6, 3, 3, 3]))
    np.testing.assert_array_equal(I.Dirac(groups=2)([6, 3, 3, 3]).numpy(),
                                  want)


# -- nn.utils ---------------------------------------------------------------


def _utils_pair(apply, ctor, seed=1):
    """Reference and port layers of the same weights with `apply` (the
    reparameterisation of each package) applied."""
    jm, tm, _ = layer_pair(ctor, seed=seed)
    apply[0](jm)
    apply[1](tm)
    return jm, tm


def test_weight_norm_matches_the_reference():
    for dim in (0, 1, None):
        jm, tm = _utils_pair(
            (lambda m: jnn.utils.weight_norm(m, dim=dim),
             lambda m: tnn.utils.weight_norm(m, dim=dim)),
            lambda nn: nn.Linear(5, 4))
        names = ["bias", "weight_g", "weight_v"]
        assert sorted(tm.state_dict()) == sorted(jm.state_dict()) == names
        x = np.random.default_rng(2).standard_normal((3, 5)).astype(
            np.float32)
        want, want_g = run_ref(None, [x], True, jm)
        got, got_g = run_port(None, [x], True, tm)
        assert_same(got, want, 1e-6, f"weight_norm dim={dim}")
        assert_same(got_g, want_g, 1e-6, f"weight_norm dim={dim} grad")
        # g / v loaded from the reference's state carry its trajectory
        tm2 = tnn.utils.weight_norm(tnn.Linear(5, 4), dim=dim)
        weights.from_paddle_tpu_values(
            {k: np.asarray(v) for k, v in state_values(jm).items()}, tm2)
        assert_same([to_np(tm2(torch.tensor(x)))], want, 1e-6, "loaded")
    tnn.utils.remove_weight_norm(tm)
    jnn.utils.remove_weight_norm(jm)
    assert sorted(tm.state_dict()) == ["bias", "weight"]
    np.testing.assert_allclose(to_np(tm.weight), to_np(jm.weight),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ctor", [
    lambda nn: nn.Linear(6, 4), lambda nn: nn.Conv2D(3, 5, 3),
    lambda nn: nn.Conv2DTranspose(3, 4, 2)], ids=["linear", "conv",
                                                 "conv_transpose"])
def test_spectral_norm_matches_the_reference(ctor):
    jm, tm = _utils_pair((lambda m: jnn.utils.spectral_norm(m),
                          lambda m: tnn.utils.spectral_norm(m)), ctor)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    for k in ("weight_u", "weight_v"):
        np.testing.assert_allclose(to_np(tm.state_dict()[k]),
                                   to_np(jm.state_dict()[k]), rtol=1e-5,
                                   atol=1e-6)
    shape = (2, 6) if isinstance(tm, tnn.Linear) else (2, 3, 5, 5)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want, want_g = run_ref(None, [x], True, jm)
    got, got_g = run_port(None, [x], True, tm)
    assert_same(got, want, 1e-5, "spectral_norm")
    assert_same(got_g, want_g, 1e-5, "spectral_norm grad")
    for k in ("weight_u", "weight_v"):       # one more power iteration
        np.testing.assert_allclose(to_np(tm.state_dict()[k]),
                                   to_np(jm.state_dict()[k]), rtol=1e-4,
                                   atol=1e-5)


def test_spectral_norm_layer_state_crosses_the_boundary():
    jm = jnn.SpectralNorm([5, 6], dim=1, power_iters=3)
    tm = tnn.SpectralNorm([5, 6], dim=1, power_iters=3)
    vals = {k: np.asarray(v) for k, v in state_values(jm).items()}
    assert sorted(vals) == ["weight_u", "weight_v"]
    weights.from_paddle_tpu_values(vals, tm)
    w = np.random.default_rng(4).standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tm(torch.tensor(w)).numpy(),
        to_np(jm(paddle.to_tensor(w))), rtol=1e-5, atol=1e-6)
    assert not tm.weight_u.requires_grad and not tm.weight_v.requires_grad
