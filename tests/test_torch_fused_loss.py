"""Port parity: paddle_tpu_torch's fused LM-head loss (ops/fused_loss.py)
against paddle_tpu's, on the same numpy inputs (n 37, h 64, v 301,
chunk 128: no row, vocab or chunk boundary aligned; n 200, h 128,
v 777, past several of the kernels' 64- and 128-row tiles; and n 70,
h 1024, v 513, the widest head the kernels take).

- the plain forward (nll, lse) and backward (dx, dw) against the
  reference's lax path (``_fwd_lax`` / ``_bwd_lax``) and its Pallas
  kernels in interpret mode (``PADDLE_TPU_LMLOSS_FORCE=pallas``, as
  tests/test_fused_loss.py runs them), with 30% and 85% of the rows
  ignored and with every row ignored: nll, lse and f32 gradients within
  1e-5 (sums in other orders); bf16 gradients within 2e-2 relative over
  an absolute floor of one bf16 ulp of the largest element, and bit for
  bit on all but 1% of the elements (the scores are f32 on both sides
  and d rounds to bf16 before both products);
- the public op's three reductions and its gradients against the
  reference op on both of its paths;
- the autograd Function's gradients against autograd of
  ``cross_entropy(x @ w.T)``, directly and through
  ``F.fused_linear_cross_entropy`` under bf16 ``auto_cast`` (both
  operands enter as bf16, the table's gradient comes back f32);
- ``DeferredLMHead.materialize()`` equal to the unfused logits.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.op_registry import lookup
from paddle_tpu.ops import fused_loss as jfl

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_loss as tfl

N, H, V, CV = 37, 64, 301, 128
_JOP = lookup("fused_linear_cross_entropy").fn


class _force:
    """PADDLE_TPU_LMLOSS_FORCE for the reference's op (read per call)."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.prev = os.environ.get("PADDLE_TPU_LMLOSS_FORCE")
        os.environ["PADDLE_TPU_LMLOSS_FORCE"] = self.mode

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("PADDLE_TPU_LMLOSS_FORCE", None)
        else:
            os.environ["PADDLE_TPU_LMLOSS_FORCE"] = self.prev


def _data(masked, seed=0, n=N, h=H, v=V):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, h) * 0.5).astype(np.float32)
    w = (rs.randn(v, h) * 0.1).astype(np.float32)
    lbl = rs.randint(0, v, n).astype(np.int32)
    lbl[rs.rand(n) < masked] = -100
    g = rs.rand(n).astype(np.float32)
    g[lbl == -100] = 0.0
    return x, w, lbl, g


def _close(got, want, dtype):
    """f32 within 1e-5. bf16 within 2e-2 relative over an absolute floor
    of one bf16 ulp of the largest element (2^-8 of it), and bit for bit
    on all but 1% of the elements: both sides round d to bf16 from f32
    scores, so only a rounding-boundary flip may differ, while a d kept
    in f32 moves the last bit of 4-40% of them."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2.0 ** -8 * float(
        np.abs(want).max(initial=0.0)))
    assert (got != want).mean() <= 0.01, (got != want).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [0.3, 0.85, 1.0],
                         ids=["some", "heavy", "all_ignored"])
@pytest.mark.parametrize("mode", ["lax", "pallas"])
def test_plain_fwd_bwd_match_reference(mode, masked, dtype):
    x, w, lbl, g = _data(masked)
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    jl, jg = jnp.asarray(lbl), jnp.asarray(g)
    with _force(mode):
        if mode == "lax":
            jnll, jlse = jfl._fwd_lax(jx, jw, jl, CV)
            jdx, jdw = jfl._bwd_lax(jx, jw, jl, jlse, jg, CV)
        else:
            jnll, jlse = jfl._fwd_pallas(jx, jw, jl, CV)
            jdx, jdw = jfl._bwd_pallas(jx, jw, jl, jlse, jg, CV)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(a).to(tdt) for a in (x, w))
    tl = torch.from_numpy(lbl).long()
    nll, lse = tfl._fwd_plain(tx, tw, tl, CV)
    dx, dw = tfl._bwd_plain(tx, tw, tl, lse, torch.from_numpy(g), CV)
    assert dx.dtype == tdt and dw.dtype == tdt
    valid = lbl != -100
    # nll and lse are f32 from f32 scores in both dtypes
    _close(lse.numpy(), jlse, "float32")
    _close(nll.numpy()[valid], np.asarray(jnll)[valid], "float32")
    assert np.isfinite(nll.numpy()).all()
    for got, want in ((dx, jdx), (dw, jdw)):
        _close(got.float().numpy(), want.astype(jnp.float32), dtype)


def _ragged_case(mode, dtype, n, h, v, seed):
    x, w, lbl, g = _data(0.3, seed=seed, n=n, h=h, v=v)
    lbl[-1] = v - 1             # a label in the last, partial vocab tile
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    jl, jg = jnp.asarray(lbl), jnp.asarray(g)
    with _force(mode):
        fwd, bwd = ((jfl._fwd_lax, jfl._bwd_lax) if mode == "lax" else
                    (jfl._fwd_pallas, jfl._bwd_pallas))
        jnll, jlse = fwd(jx, jw, jl, CV)
        jdx, jdw = bwd(jx, jw, jl, jlse, jg, CV)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(a).to(tdt) for a in (x, w))
    tl = torch.from_numpy(lbl).long()
    nll, lse = tfl._fwd_plain(tx, tw, tl, CV)
    dx, dw = tfl._bwd_plain(tx, tw, tl, lse, torch.from_numpy(g), CV)
    valid = lbl != -100
    _close(lse.numpy(), jlse, "float32")
    _close(nll.numpy()[valid], np.asarray(jnll)[valid], "float32")
    for got, want in ((dx, jdx), (dw, jdw)):
        _close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lax", "pallas"])
def test_plain_fwd_bwd_match_reference_ragged_tiles(mode, dtype):
    """N 200 and V 777 past several of the kernels' 64- and 128-row tiles
    (neither a multiple of either), H 128, plain chunks of 128 that do not
    divide V, a label in the last vocab tile: the same tolerances as
    above."""
    _ragged_case(mode, dtype, 200, 128, 777, seed=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lax", "pallas"])
def test_plain_fwd_bwd_match_reference_ragged_head_h1024(mode, dtype):
    """The widest hidden size the kernels take (H 1024: B4 owns 64 token
    rows there, B5 / B6 keep their 32-row kernel) at N 70 and V 513, one
    column past four 128-row vocab tiles: the same tolerances as above."""
    _ragged_case(mode, dtype, 70, 1024, 513, seed=5)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("mode", ["lax", "pallas"])
def test_public_op_reductions_and_grads_match_reference(mode, reduction):
    x, w, lbl, _ = _data(0.3, seed=1)
    jl = jnp.asarray(lbl)

    def jloss(x_, w_):
        out = _JOP(x_, w_, jl, chunk_v=CV, reduction=reduction)
        return jnp.sum(out) if reduction == "none" else out

    with _force(mode):
        jout = _JOP(jnp.asarray(x), jnp.asarray(w), jl, chunk_v=CV,
                    reduction=reduction)
        jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = tfl.fused_linear_cross_entropy(tx, tw, torch.from_numpy(lbl),
                                         chunk_v=CV, reduction=reduction)
    (out.sum() if reduction == "none" else out).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-6)


def test_autograd_matches_unfused_cross_entropy():
    x, w, lbl, _ = _data(0.3, seed=2)
    lt = torch.from_numpy(lbl).long()
    x3 = torch.from_numpy(x).reshape(1, N, H)     # leading dims reshape
    grads = []
    for fused in (True, False):
        tx = x3.clone().requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        if fused:
            loss = tfl.fused_linear_cross_entropy(tx, tw, lt.reshape(1, N),
                                                  chunk_v=100)
        else:
            loss = TF.cross_entropy(torch.matmul(tx, tw.t()),
                                    lt.reshape(1, N))
        loss.backward()
        grads.append((loss.detach(), tx.grad, tw.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    # under bf16 auto_cast both operands enter as bf16; dw returns f32
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    with tamp.auto_cast(enable=True, dtype="bfloat16"):
        loss = TF.fused_linear_cross_entropy(tx, tw, lt)
    loss.backward()
    assert loss.dtype == torch.float32 and tw.grad.dtype == torch.float32
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    nll, lse = tfl._fwd_plain(xb, wb, lt, 1024)
    valid = lt != -100
    torch.testing.assert_close(loss.detach(), nll[valid].mean(), rtol=1e-6,
                               atol=1e-6)
    _, dw = tfl._bwd_plain(xb, wb, lt, lse,
                           valid.float() / valid.float().sum(), 1024)
    torch.testing.assert_close(tw.grad, dw.float(), rtol=0, atol=0)


def test_deferred_head_materializes_the_unfused_logits():
    x, w, _, _ = _data(0.3, seed=3)
    h = tfl.DeferredLMHead(torch.from_numpy(x).reshape(1, N, H),
                           torch.from_numpy(w))
    want = torch.matmul(h.hidden, h.weight.t())
    torch.testing.assert_close(h.materialize(), want, rtol=0, atol=0)
    assert h.materialize().shape == (1, N, V)
