"""Port parity: every public function of paddle_tpu_torch.nn.functional
against paddle_tpu's on the same numpy inputs (tests/torch_nn_cases.py).

* One case per function (several where an option changes the
  arithmetic): the outputs agree within rtol 1e-5 / atol 1e-6 in f32, or
  atol 1e-5 where the case sums 64 or more terms (``red`` in the
  table), and so do the gradients of every float input against a fixed
  cotangent (each package's autograd).
* One case per function under ``auto_cast`` O1 (bf16): its output
  dtypes with f32 inputs, and the set of AMP-listed op names under which
  it casts its inputs (``paddle_tpu.core.dispatch._amp_rewrite`` calls
  against the port's ``amp.cast`` calls), so the black list computes in
  f32, the white list in bf16 and the rest keeps its input dtype in both
  packages alike.
* Coverage: every function of the reference's nn.functional exists in
  the port and has a case, bar the waiting set.
* The random ops (dropout, dropout2d / 3d, alpha_dropout,
  gumbel_softmax) by their properties: the kept share, the scaling,
  whole channels, the affine correction, one-hot rows.
* The ``scaled_dot_product_attention`` signature: ``[b, s, h, d]``
  inputs by default, with and without a mask, as the reference's.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp
from torch_nn_cases import F_CASES, RANDOM_FUNCTIONS
from torch_nn_parity import JREF, assert_same, flat, run_port, run_ref, \
    to_np

@pytest.mark.parametrize("case", F_CASES, ids=lambda c: c.id)
def test_functional_parity(case):
    arrays = case.inputs()
    want, want_g = run_ref(case.call, arrays, case.grad)
    got, got_g = run_port(case.call, arrays, case.grad)
    assert_same(got, want, case.atol, f"{case.id} forward")
    if case.grad:
        assert_same(got_g, want_g, case.atol, f"{case.id} grad")


def _first_cases():
    seen, out = set(), []
    for c in F_CASES:
        if c.fn not in seen:
            seen.add(c.fn)
            out.append(c)
    return out


_LISTED = tamp.AMP_WHITE_LIST | tamp.AMP_BLACK_LIST


def o1_run(call, arrays, monkeypatch):
    """Output dtypes of `call` under auto_cast O1 (bf16) in both packages,
    and the AMP-listed op names each package cast inputs under."""
    from paddle_tpu.core import dispatch

    ref_names, port_names = set(), set()
    rewrite = dispatch._amp_rewrite

    def rec_ref(op_name, arrs):
        ref_names.add(op_name)
        return rewrite(op_name, arrs)

    cast = tamp.cast

    def rec_port(op_name, *tensors):
        port_names.add(op_name)
        return cast(op_name, *tensors)

    monkeypatch.setattr(dispatch, "_amp_rewrite", rec_ref)
    monkeypatch.setattr(tamp, "cast", rec_port)
    with jamp.auto_cast(enable=True, level="O1", dtype="bfloat16"):
        want = [str(o._value.dtype) for o in
                flat(call(JREF, *(paddle.to_tensor(a) for a in arrays)))]
    with tamp.auto_cast(enable=True, dtype="bfloat16"):
        got = [str(o.dtype).replace("torch.", "") for o in
               flat(call(TF, *(torch.tensor(a) for a in arrays)))]
    # x64 is off in the reference: its integer outputs are int32
    ints = {"int32": "int", "int64": "int"}
    return ([ints.get(d, d) for d in got], [ints.get(d, d) for d in want],
            port_names & _LISTED, ref_names & _LISTED)


@pytest.mark.parametrize("case", _first_cases(), ids=lambda c: c.fn)
def test_functional_o1_dtype(case, monkeypatch):
    """The output dtypes under O1 with f32 inputs, and the set of
    AMP-listed op names the call casts under (so bf16 inputs meet the
    same black-list casts in both packages)."""
    got, want, got_ops, want_ops = o1_run(case.call, case.inputs(),
                                          monkeypatch)
    assert got == want, (case.fn, got, want)
    assert got_ops == want_ops, (case.fn, got_ops, want_ops)


def test_every_reference_function_exists_and_has_a_case():
    ref = {n for n, v in vars(JF).items() if not n.startswith("_")
           and inspect.isfunction(v) and v.__module__ == JF.__name__}
    assert len(ref) == 90
    port = set(TF.__all__)
    assert ref - port == set()
    for name in port:
        assert callable(getattr(TF, name)), name
    covered = {c.fn for c in F_CASES} | set(RANDOM_FUNCTIONS)
    assert ref - covered == set()
    # the waiting set: sparse lookups need SelectedRows gradients
    with pytest.raises(NotImplementedError, match="sparse"):
        TF.embedding(torch.zeros(2, dtype=torch.long), torch.zeros(3, 4),
                     sparse=True)


@pytest.mark.parametrize("pad", ["SAME", "VALID"])
def test_conv_transpose_string_padding_like_the_reference(pad):
    """lax takes 'SAME' / 'VALID' on a transposed conv at stride 1 only:
    the same output there, and an error at stride 2 in both packages."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 2, 5, 4)).astype(np.float32)
    w = rng.standard_normal((2, 3, 3, 2)).astype(np.float32)
    want = to_np(JF.conv2d_transpose(paddle.to_tensor(x),
                                     paddle.to_tensor(w), padding=pad,
                                     dilation=2))
    got = TF.conv2d_transpose(torch.tensor(x), torch.tensor(w), padding=pad,
                              dilation=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                            stride=2, padding=pad)
    with pytest.raises(ValueError, match="string padding"):
        TF.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                            padding=pad)


# -- the random ops by their properties --------------------------------------


def _draw(fn, x, *args, **kw):
    from paddle_tpu_torch.framework import random as trandom

    with trandom.rng_scope(trandom.RngState(5, "cpu")):
        return fn(x, *args, **kw)


def test_dropout_keeps_its_share_and_scales():
    x = torch.ones(200, 300)
    y = _draw(TF.dropout, x, 0.3)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    y = _draw(TF.dropout, x, 0.3, mode="downscale_in_infer")
    assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    assert torch.equal(TF.dropout(x, 0.3, training=False), x)
    torch.testing.assert_close(
        TF.dropout(x, 0.3, training=False, mode="downscale_in_infer"),
        x * 0.7)


@pytest.mark.parametrize("fn,shape,fmt", [
    ("dropout2d", (16, 64, 3, 3), "NCHW"),
    ("dropout2d", (16, 3, 3, 64), "NHWC"),
    ("dropout3d", (8, 64, 2, 2, 2), "NCDHW")])
def test_channel_dropout_drops_whole_channels(fn, shape, fmt):
    x = torch.ones(shape)
    y = _draw(getattr(TF, fn), x, 0.4, data_format=fmt)
    c_axis = 1 if fmt.startswith("NC") else -1
    yc = y.movedim(c_axis, 1).flatten(2)          # [n, c, rest]
    assert bool((yc.amin(-1) == yc.amax(-1)).all())
    first = yc[..., 0]
    kept = first != 0
    torch.testing.assert_close(first[kept],
                               torch.full_like(first[kept], 1 / 0.6))
    assert abs(kept.float().mean().item() - 0.6) < 0.1
    assert torch.equal(getattr(TF, fn)(x, 0.4, training=False,
                                       data_format=fmt), x)


def test_alpha_dropout_keeps_mean_and_variance():
    x = torch.randn(400, 500, generator=torch.Generator().manual_seed(1))
    y = _draw(TF.alpha_dropout, x, 0.2)
    assert abs(y.mean().item()) < 0.02
    assert abs(y.std().item() - 1.0) < 0.02
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - 0.2) * (1 + 0.2 * alpha_p ** 2)) ** -0.5
    dropped = torch.isclose(y, torch.tensor(alpha_p * a - a * alpha_p * 0.2))
    assert abs(dropped.float().mean().item() - 0.2) < 0.01


def test_gumbel_softmax_rows():
    x = torch.randn(64, 10, generator=torch.Generator().manual_seed(2))
    y = _draw(TF.gumbel_softmax, x, 0.5)
    torch.testing.assert_close(y.sum(-1), torch.ones(64))
    assert bool((y >= 0).all())
    x.requires_grad_(True)
    h = _draw(TF.gumbel_softmax, x, 0.5, hard=True)
    hd = h.detach()
    torch.testing.assert_close(hd, (hd > 0.5).float())
    assert bool(((hd > 0.5).sum(-1) == 1).all())
    (h * torch.arange(10.0)).sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)


# -- the repaired scaled_dot_product_attention signature ----------------------


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_sdpa_takes_bshd_like_the_reference(mask):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
               for _ in range(3))
    m = None
    if mask == "bool":
        m = rng.random((2, 4, 6, 6)) > 0.3
        m[..., 0] = True
    elif mask == "float":
        m = np.where(rng.random((6, 6)) > 0.3, 0.0, -1e9).astype(np.float32)
    jm = None if m is None else paddle.to_tensor(m)
    tm = None if m is None else torch.tensor(m)
    want = to_np(JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), attn_mask=jm))
    got = TF.scaled_dot_product_attention(
        *(torch.tensor(a) for a in (q, k, v)), attn_mask=tm)
    assert tuple(got.shape) == (2, 6, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # head-major inputs give the same result with qkv_layout="bhsd"
    got_h = TF.scaled_dot_product_attention(
        *(torch.tensor(a).transpose(1, 2) for a in (q, k, v)),
        attn_mask=tm, qkv_layout="bhsd")
    np.testing.assert_allclose(got_h.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-7)
