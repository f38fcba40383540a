"""Port parity: gradient clipping and paddle.save / paddle.load.

- `ClipGradByValue`, `ClipGradByNorm` and `ClipGradByGlobalNorm` over
  ``(param, grad)`` pairs against the reference's, with one parameter of
  ``need_clip=False`` (left as it is, and out of the global norm); the
  engine-side ``_clip_fn`` over the ``{name: grad}`` dict, given the
  parameters by name, gives the same gradients; a port ``Engine`` step with a ``need_clip=False``
  `ParamAttr` equals the reference's eager step (whose clippers honour
  ``need_clip``), within rtol 1e-6 (f32 sums in other orders).
- ``save`` / ``load`` both ways: a ``.pdparams`` written by
  ``paddle_tpu.save`` loads into the port's GPT with logits equal to
  the reference model's (within 1e-5), and the reverse; an optimizer
  state dict crosses both ways with the same keys and values; nested
  containers of tensors come back as numpy arrays in the same shape.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.clip import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.param_attr import ParamAttr as JParamAttr

import paddle_tpu_torch as pt
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.nn import Parameter as TParameter
from torch_parity import build_pair, mlp_batches, mlp_mse, mlp_pair

# the reference's clippers (paddle_tpu.clip, the module: the package's
# `clip` attribute is the tensor op)
jclip = SimpleNamespace(ClipGradByValue=ClipGradByValue,
                        ClipGradByNorm=ClipGradByNorm,
                        ClipGradByGlobalNorm=ClipGradByGlobalNorm)

CLIPS = {"value": lambda m: m.ClipGradByValue(0.3),
         "value_min": lambda m: m.ClipGradByValue(0.4, min=-0.1),
         "norm": lambda m: m.ClipGradByNorm(0.5),
         "global": lambda m: m.ClipGradByGlobalNorm(1.0)}


def _params_grads(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"a": (4, 5), "b": (5,), "c": (3, 3)}
    vals = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return vals, grads


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clips_with_need_clip_match_reference(kind):
    vals, grads = _params_grads()
    jpairs, tpairs, tparams = [], [], {}
    for k in vals:
        jp = JParameter(jnp.asarray(vals[k]), name=k)
        tp = TParameter(torch.from_numpy(vals[k].copy()))
        tp.name = k
        tparams[k] = tp
        jp.need_clip = tp.need_clip = k != "b"
        jpairs.append((jp, paddle.to_tensor(grads[k])))
        tpairs.append((tp, torch.from_numpy(grads[k].copy())))
    want = [np.asarray(g._value) for _, g in CLIPS[kind](jclip)(jpairs)]
    got = [g.numpy() for _, g in CLIPS[kind](tclip)(tpairs)]
    fn = CLIPS[kind](tclip)._clip_fn(
        {k: torch.from_numpy(g.copy()) for k, g in grads.items()},
        tparams)
    for (k, g0), w, g in zip(grads.items(), want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(fn[k].numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(got[1], grads["b"])
    assert not np.allclose(got[0], grads["a"])


@pytest.mark.parametrize("kind", ["value", "norm", "global"])
def test_engine_path_honours_need_clip_like_the_reference_eager_step(kind):
    jm, tm = mlp_pair({"w1": JParamAttr(need_clip=False)},
                      {"w1": pt.ParamAttr(need_clip=False)})
    assert tm.fc1.weight.need_clip is False
    jo = paddle.optimizer.SGD(0.5, parameters=jm.parameters(),
                              grad_clip=CLIPS[kind](jclip))
    teng = TEngine(tm, topt.SGD(0.5, parameters=tm.parameters(),
                                grad_clip=CLIPS[kind](tclip)),
                   mlp_mse, device="cpu")
    for x, y in mlp_batches(2):
        mlp_mse(jm(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
        jo.step()
        jo.clear_grad()
        teng.train_batch((x,), (y,))
    for (k, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(
            jp._value), rtol=1e-6, atol=1e-7, err_msg=k)


def _logits(jm, tm, ids):
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    return got, want


def test_pdparams_written_by_the_reference_load_into_the_port(tmp_path):
    jm, _, _ = build_pair(seed=0)
    _, tm, _ = build_pair(seed=1)
    path = str(tmp_path / "ref.pdparams")
    paddle.save(jm.state_dict(), path)
    missing, unexpected = tm.set_state_dict(pt.load(path))
    assert missing == [] and unexpected == []
    tm.eval()
    ids = np.random.RandomState(4).randint(0, 97, (2, 11))
    got, want = _logits(jm, tm, ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pdparams_written_by_the_port_load_into_the_reference(tmp_path):
    _, tm, _ = build_pair(seed=2)
    jm, _, _ = build_pair(seed=3)
    tm.eval()
    path = str(tmp_path / "port.pdparams")
    pt.save(tm.state_dict(), path)
    sd = paddle.load(path)
    assert all(isinstance(v, np.ndarray) for v in sd.values())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
    ids = np.random.RandomState(5).randint(0, 97, (2, 11))
    got, want = _logits(jm, tm, ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_optimizer_state_crosses_both_ways(tmp_path):
    jm, tm = mlp_pair()
    sched = (paddle.optimizer.lr.ExponentialDecay(0.01, gamma=0.9),
             topt.lr.ExponentialDecay(0.01, gamma=0.9))
    jo = paddle.optimizer.Adam(sched[0], parameters=jm.parameters())
    to = topt.Adam(sched[1], parameters=tm.parameters())
    x, y = mlp_batches(1)[0]
    mlp_mse(jm(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
    jo.step()
    mlp_mse(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    to.step()
    paddle.save(jo.state_dict(), str(tmp_path / "ref.pdopt"))
    pt.save(to.state_dict(), str(tmp_path / "port.pdopt"))
    from_ref = pt.load(str(tmp_path / "ref.pdopt"))
    from_port = paddle.load(str(tmp_path / "port.pdopt"))
    assert sorted(from_ref) == sorted(from_port)
    for k, v in from_ref.items():
        if k == "LR_Scheduler":
            assert v == from_port[k]
        elif k != "global_step":
            np.testing.assert_allclose(from_port[k], v, rtol=1e-6,
                                       atol=1e-8, err_msg=k)
    to2 = topt.Adam(topt.lr.ExponentialDecay(0.01, gamma=0.9),
                    parameters=tm.parameters())
    to2.set_state_dict(from_ref)
    jo2 = paddle.optimizer.Adam(paddle.optimizer.lr.ExponentialDecay(
        0.01, gamma=0.9), parameters=jm.parameters())
    jo2.set_state_dict(from_port)
    assert sorted(to2.state_dict()) == sorted(jo2.state_dict())


def test_nested_containers_round_trip(tmp_path):
    obj = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "b": [torch.ones(2), (torch.zeros(1, dtype=torch.int64), 3)],
           "c": "text"}
    path = str(tmp_path / "nested.pdparams")
    pt.save(obj, path)
    for back in (pt.load(path), paddle.load(path)):
        np.testing.assert_array_equal(back["a"], obj["a"].numpy())
        assert isinstance(back["b"], list) and isinstance(back["b"][1],
                                                          tuple)
        assert back["b"][1][1] == 3 and back["c"] == "text"
        assert back["b"][1][0].dtype == np.int64
