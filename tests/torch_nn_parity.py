"""Runners of the nn parity tests: a case of tests/torch_nn_cases.py
through paddle_tpu and through paddle_tpu_torch on the CPU, forward and
backward, and the comparison of the two within the case's tolerance.

A layer case builds the layer in both packages, checks that their state
names and shapes agree, loads the same random numpy values into both
(`layer_values`) and runs them in the case's mode; its gradients cover
the float inputs and every trainable parameter, by name, and its state
after the call (a batch norm's running stats) is compared too.
"""

from __future__ import annotations

import types

import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from torch_nn_cases import RTOL, layer_values

# the reference's matmul lives in paddle.matmul
JREF = types.SimpleNamespace(**{k: getattr(JF, k) for k in dir(JF)
                                if not k.startswith("_")})
JREF.matmul = lambda x, y, transpose_y=False: paddle.matmul(
    x, y, transpose_y=transpose_y)


def to_np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    if "float" in str(t._value.dtype):
        return np.asarray(t.numpy()).astype(np.float32)
    return np.asarray(t.numpy())


def flat(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in flat(x)]
    return [out]


def is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def cotangents(outs, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            if is_float(o) else None for o in outs]


def _ref_grads(outs, got, params):
    loss = None
    for o, ct in zip(outs, cotangents(got)):
        if ct is not None:
            term = (o * paddle.to_tensor(ct)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return {k: None if p.grad is None else to_np(p.grad)
            for k, p in params.items()}


def _port_grads(outs, got, params, device):
    loss = sum((o * torch.tensor(ct, device=device)).sum()
               for o, ct in zip(outs, cotangents(got)) if ct is not None)
    loss.backward()
    return {k: None if p.grad is None else to_np(p.grad)
            for k, p in params.items()}


def run_ref(call, arrays, grad, layer=None):
    """(outputs, {name: grad}) of the reference; inputs are named
    ``in<i>``, a layer's parameters by their structured names."""
    ts = [paddle.to_tensor(a, stop_gradient=not (grad and is_float(a)))
          for a in arrays]
    if layer is None:
        outs = flat(call(JREF, *ts))
    else:
        outs = flat(call(layer, *ts) if call else layer(*ts))
    got = [to_np(o) for o in outs]
    if not grad:
        return got, None
    params = {f"in{i}": t for i, t in enumerate(ts) if is_float(arrays[i])}
    if layer is not None:
        params.update({k: p for k, p in layer.named_parameters()
                       if not p.stop_gradient})
    return got, _ref_grads(outs, got, params)


def run_port(call, arrays, grad, layer=None, device="cpu"):
    ts = [torch.tensor(a, device=device) for a in arrays]
    for t in ts:
        if grad and t.is_floating_point():
            t.requires_grad_(True)
    if layer is None:
        outs = flat(call(TF, *ts))
    else:
        outs = flat(call(layer, *ts) if call else layer(*ts))
    got = [to_np(o) for o in outs]
    if not grad:
        return got, None
    params = {f"in{i}": t for i, t in enumerate(ts) if t.is_floating_point()}
    if layer is not None:
        params.update({k: p for k, p in layer.named_parameters()
                       if p.requires_grad})
    return got, _port_grads(outs, got, params, device)


def assert_same(got, want, atol, what, rtol=RTOL):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        keys = sorted(want)
        got, want = [got[k] for k in keys], [want[k] for k in keys]
    else:
        keys = range(len(want))
    assert len(got) == len(want), what
    for k, g, w in zip(keys, got, want):
        if g is None or w is None:
            # a gradient one side leaves None is zero on the other
            other = g if g is not None else w
            assert other is None or not np.any(other != 0), f"{what}[{k}]"
            continue
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if is_float(w):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{what}[{k}]")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{k}]")


def layer_pair(ctor, train=True, seed=0):
    """(reference layer, port layer, values): built by ``ctor(nn)`` in both
    packages, same state names and shapes, the same random values."""
    jm, tm = ctor(jnn), ctor(tnn)
    jshapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tshapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tshapes == jshapes
    vals = layer_values(jshapes, seed)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    missing, unexpected = tm.set_state_dict(vals)
    assert missing == [] and unexpected == []
    for m in (jm, tm):
        m.train() if train else m.eval()
    return jm, tm, vals


def check_layer_case(case):
    """A layer case in both packages. A layer without parameters is held
    to the reference's forward only: its gradient is its functional op's,
    which test_torch_nn_functional.py holds to the reference."""
    ctor, call = case.call
    jm, tm, _ = layer_pair(ctor, case.train)
    arrays = case.inputs()
    grad = case.grad and any(True for _ in tm.parameters())
    want, want_g = run_ref(call, arrays, grad, jm)
    got, got_g = run_port(call, arrays, grad, tm)
    assert_same(got, want, case.atol, f"{case.id} forward")
    if grad:
        assert_same(got_g, want_g, case.atol, f"{case.id} grad")
    assert_same({k: to_np(v) for k, v in tm.state_dict().items()},
                {k: to_np(v) for k, v in jm.state_dict().items()},
                case.atol, f"{case.id} state after the call")
