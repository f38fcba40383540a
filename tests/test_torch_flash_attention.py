"""Port parity: paddle_tpu_torch's flash attention (the plain PyTorch
versions behind kernels B1-B3, which CPU tensors take) against
paddle_tpu's ``ops.fused_ops.flash_attention``, on its jnp path and on
its Pallas kernels in interpret mode (``PADDLE_TPU_FLASH_FORCE=pallas``;
in f32 and bf16, sq != sk both ways; fully masked rows against the jnp
path, see ``INTERP_CASES``).

Tolerances: f32 ``o`` within rtol=atol=1e-5 and gradients within 2e-4
(f32 sums in other orders); bf16 within 2e-2 (both round p and ds to
bf16 before their products, at slightly different values).

Dropout cannot be compared with the reference bit for bit (its mask
comes from jax.random / the TPU's PRNG), so the port's own mask is
checked: its hash against an independent numpy murmur3, its keep rate,
its determinism in the seed, the backward regenerating the forward's
mask, and the custom backward against torch autograd of the plain
forward with the same mask.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import fused_ops as jfo
import paddle_tpu as paddle

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_ops as tfo

# (b, h, sq, sk, d): ragged, sq != sk both ways (bottom-right causal)
SHAPES = [(2, 3, 33, 33, 16), (1, 2, 9, 21, 8), (1, 2, 21, 9, 8)]


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32)
               for n in (sq, sk, sk))
    w = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, w


def _jax(q, k, v, w, causal, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    o, vjp = jax.vjp(lambda a, b_, c: jfo.flash_attention(
        a, b_, c, is_causal=causal), *args)
    grads = vjp(jnp.asarray(w, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _torch(q, k, v, w, causal, dtype=torch.float32, seed=None, p=0.0):
    args = [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in (q, k, v)]
    o = tfo.flash_attention(*args, seed, is_causal=causal, dropout_p=p)
    o.backward(torch.from_numpy(w).to(dtype))
    return [x.detach().float().numpy() for x in
            (o, *(a.grad for a in args))]


def _close(got, want, tol_o, tol_g):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = tol_o if i == 0 else tol_g
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_jnp_path_f32(shape, causal):
    q, k, v, w = _inputs(*shape)
    _close(_torch(q, k, v, w, causal), _jax(q, k, v, w, causal), 1e-5, 2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_reference_jnp_path_bf16(causal):
    q, k, v, w = _inputs(2, 2, 40, 40, 16, seed=1)
    _close(_torch(q, k, v, w, causal, torch.bfloat16),
           _jax(q, k, v, w, causal, jnp.bfloat16), 2e-2, 2e-2)


# (sq, sk, dtype, causal): the square f32 cases, then bf16 and sq != sk
# both ways under causal — the shapes at which the card holds the
# tensor-core kernels against these plain versions. With sq > sk and
# causal the first sq - sk rows are fully masked; the reference's Pallas
# kernels average them over its keys padded to the 128-row block (o
# scaled by sk / 128) where its jnp path and the port average the sk
# keys, so that case is held against the jnp path.
INTERP_CASES = [
    pytest.param(70, 70, "float32", False, id="False"),
    pytest.param(70, 70, "float32", True, id="True"),
    pytest.param(70, 70, "bfloat16", False, id="bf16-70x70"),
    pytest.param(70, 70, "bfloat16", True, id="bf16-70x70-causal"),
    pytest.param(40, 70, "float32", True, id="40x70-causal"),
    pytest.param(40, 70, "bfloat16", True, id="bf16-40x70-causal"),
    pytest.param(70, 40, "float32", True, id="70x40-causal-jnp"),
    pytest.param(70, 40, "bfloat16", True, id="bf16-70x40-causal-jnp"),
]


@pytest.mark.parametrize("sq,sk,dtype,causal", INTERP_CASES)
def test_plain_matches_reference_pallas_kernels_interpret(sq, sk, dtype,
                                                           causal):
    q, k, v, w = _inputs(1, 1, sq, sk, 8, seed=3)
    masked_rows = causal and sq > sk
    os.environ["PADDLE_TPU_FLASH_FORCE"] = "jnp" if masked_rows else "pallas"
    try:
        want = _jax(q, k, v, w, causal, getattr(jnp, dtype))
    finally:
        os.environ.pop("PADDLE_TPU_FLASH_FORCE", None)
    tol = (1e-5, 2e-4) if dtype == "float32" else (2e-2, 2e-2)
    _close(_torch(q, k, v, w, causal, getattr(torch, dtype)), want, *tol)


def test_masked_sdpa_matches_reference():
    q, k, v, _ = _inputs(2, 2, 12, 12, 8, seed=5)
    mask = np.where(np.random.RandomState(6).rand(2, 1, 1, 12) < 0.3,
                    -1e4, 0.0).astype(np.float32)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        attn_mask=paddle.to_tensor(mask), qkv_layout="bhsd")
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask), qkv_layout="bhsd")
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_masked_sdpa_dropout_matches_reference_bitwise(p, monkeypatch):
    """The masked path's dropout divides the kept probabilities by 1 - p
    in their dtype, as the reference does (its dropout op multiplies by
    1 / (1 - p) instead). q = k = 0 and v = I make the output the dropped
    probabilities, exact in both packages; both draw one keep mask (the
    port's, from a generator seeded 0)."""
    from paddle_tpu_torch.framework import random as trandom

    b, h, s = 2, 2, 12
    q = np.zeros((b, h, s, s), np.float32)
    v = np.broadcast_to(np.eye(s, dtype=np.float32), (b, h, s, s)).copy()
    mask = np.where(np.random.RandomState(6).rand(b, 1, 1, s) < 0.3,
                    -1e4, 0.0).astype(np.float32)
    keep = torch.empty((b, h, s, s)).bernoulli_(
        1.0 - p, generator=torch.Generator().manual_seed(0)).bool()
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, prob, shape: jnp.asarray(keep.numpy()).reshape(shape))
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a).astype("bfloat16") for a in (q, q, v)),
        attn_mask=paddle.to_tensor(mask), dropout_p=p, training=True,
        qkv_layout="bhsd")
    with trandom.rng_scope(trandom.RngState(0, "cpu")):
        got = TF.scaled_dot_product_attention(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, q, v)),
            attn_mask=torch.from_numpy(mask), dropout_p=p, training=True,
            qkv_layout="bhsd")
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jnp.asarray(want._value).astype(jnp.float32)))


def _murmur3_numpy(seed, words):
    """murmur3_32 of little-endian 32-bit words, in numpy uint32."""
    u = np.uint32
    rotl = lambda x, r: u((int(x) << r | int(x) >> (32 - r)) & 0xFFFFFFFF)  # noqa
    with np.errstate(over="ignore"):
        h = u(seed)
        for word in words:
            kk = u(word) * u(0xCC9E2D51)
            kk = rotl(kk, 15) * u(0x1B873593)
            h = rotl(h ^ kk, 13) * u(5) + u(0xE6546B64)
        h ^= u(4 * len(words))
        h ^= h >> u(16)
        h *= u(0x85EBCA6B)
        h ^= h >> u(13)
        h *= u(0xC2B2AE35)
        return int(h ^ (h >> u(16)))


def test_dropout_hash_pinned_to_independent_numpy_murmur3():
    for seed in (0, 5, 2 ** 31 + 12345, 2 ** 32 - 1):
        got = tfo._keep_hash(torch.tensor(seed), 3, 5, 7)
        for bh, qi, ki in ((0, 0, 0), (2, 4, 6), (1, 3, 0), (2, 0, 5)):
            assert int(got[bh, qi, ki]) == _murmur3_numpy(seed, (bh, qi, ki))
    # the empty-key reference value of murmur3_32 (seed 0, no words)
    assert _murmur3_numpy(0, ()) == 0


def test_dropout_mask_rate_and_seed_determinism():
    p = 0.1
    keep = tfo._keep_mask(torch.tensor(7), 4, 64, 64, p)
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - p)) <= \
        4 * np.sqrt(p * (1 - p) / n)
    q, k, v, w = _inputs(1, 2, 24, 24, 8)
    o1 = _torch(q, k, v, w, False, seed=11, p=0.2)[0]
    o2 = _torch(q, k, v, w, False, seed=11, p=0.2)[0]
    o3 = _torch(q, k, v, w, False, seed=12, p=0.2)[0]
    np.testing.assert_array_equal(o1, o2)
    assert np.abs(o1 - o3).max() > 1e-4


def test_dropout_backward_regenerates_the_forward_mask():
    q, k, v, _ = _inputs(1, 1, 32, 32, 16, seed=3)
    o, _, _, dv = _torch(q, k, v, np.ones((1, 1, 32, 16), np.float32),
                         False, seed=5, p=0.4)
    # dv_j = sum_i pd_ij with an all-ones cotangent, so sum(o) is
    # sum(dv * v) exactly when both passes drop the same elements
    np.testing.assert_allclose(o.sum(), (dv * v).sum(), rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_backward_matches_autograd_of_plain_forward(causal):
    q, k, v, w = _inputs(2, 2, 19, 23, 8, seed=9)
    p, seed = 0.3, torch.tensor(1234)
    got = _torch(q, k, v, w, causal, seed=seed, p=p)
    args = [torch.from_numpy(a).reshape(4, *a.shape[2:]).requires_grad_(True)
            for a in (q, k, v)]
    o, _ = tfo._flash_fwd_plain(*args, seed, 1.0 / np.sqrt(8), causal, p)
    o.backward(torch.from_numpy(w).reshape(4, 19, 8))
    want = [x.detach().reshape(2, 2, *x.shape[1:]).numpy()
            for x in (o, *(a.grad for a in args))]
    _close(got, want, 1e-6, 1e-5)


def test_sdpa_without_mask_is_flash_attention_in_paddle_layout():
    q, k, v, _ = _inputs(1, 2, 10, 10, 8, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TF.scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                          qkv_layout="bhsd")
    want = tfo.flash_attention(tq, tk, tv, is_causal=True).transpose(1, 2)
    assert got.shape == (1, 10, 2, 8)
    assert torch.equal(got, want)


def test_dropout_rejects_sequences_past_the_mask_counter():
    q = torch.zeros((1, 1, 65536, 8))
    with pytest.raises(ValueError, match="65536"):
        tfo.flash_attention(q, q[:, :, :4], q[:, :, :4], dropout_p=0.1)
