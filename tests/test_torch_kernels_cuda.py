"""The port's CUDA kernels against their plain PyTorch versions, on the
card: B7 `dequant_matmul` within rtol=atol=1e-5 (f32 sums in another
order, x carried in two f16 pieces), B8 `w8a8_matmul` bitwise (exact
int32 sums), both at ragged shapes and table views and repeating bit for
bit, B9 `scaled_matmul`
int8 bitwise and fp8 within 4 K 2^-24 of the sum of the absolute
products (f32 sums in another order; its e4m3 codes bitwise through an
identity operand), with f32 and bf16 operands, a Linear weight and a
transposed vocab chunk as b, at ragged shapes (int8 also with f16
operands), B1-B3 flash
attention within 1e-5 (o) / 2e-4 (grads) in f32 (sums in another
order) and 2e-2 in bf16 (B1-B3 on the tensor cores; B1 rounds p
divided by the running row sum to bf16 before its value product where
the plain version rounds the normalised p, and the kernels' exp is the
hardware's approximation), at every head dim, ragged rows, sq != sk,
packed q / k / v views and a transposed output gradient, with the
dropout mask equal bit for bit and the bf16 backward repeating bit for
bit, and the f16 instantiation within 2.5e-3 (the bf16 gate scaled by
the formats' epsilons); B4-B6 (the
fused LM-head loss) within 1e-5 in f32 at ragged shapes (vocab tails,
heavy masking, every row ignored), B4 in bf16 within 1e-4 (nll, lse)
at every hidden size, ragged token counts and vocab tails and the
ERNIE head, repeating bit for bit, B5 / B6 within one bf16 ulp in bf16
(the plain version's f32 scores are summed in another order, which can
move d across a bf16 rounding boundary), and in bf16 at ragged shapes
against B6's 64-row tiles (every hidden size) with exact scores, where
both sides round the same d, within one bf16 ulp (the f16
instantiation within one f16 ulp); repeating bit for bit; B10
(the fused conv) with every epilogue (none, moments, affine with and
without a residual, ReLU and identity) at ragged pixel counts, channel
counts (12 as the space-to-depth stem, odd ones) and output widths,
through the stride-2 lowering and the dx parity planes, at each of the
bf16 kernel's three tile widths: f32 within rtol 1e-5 and 1e-5 of the
largest element (sums in another order), bf16 (and f16) y within one
ulp of its dtype and the moments within 1e-4 relative, repeating bit for bit; each
launch counted; B5 repeating bit for bit at the ERNIE head; B7 and
B8 giving each row the bits of its own one-row call at 8-40 rows (the
speculative verify head), and B1 each (batch, head) the same bits at
batch sizes 1-32 (the dynamic batcher's buckets); a 2-replica int8
fleet (B7 in both replica threads) with the CPU fleet's greedy tokens
up to a near-tie (a flip only where the two devices' logits differ by
at least half the CPU row's top-2 margin), and B7's launch counter
equal to the replicas' summed steps plus their warm-ups. Without a card
every test skips.

This file imports neither jax nor paddle_tpu, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_conv, fused_loss, fused_ops, lowp, \
    quant_ops

# the serving head's shape, then ragged ones against B7's and B8's
# 128-row table tiles, 128-byte K steps and 8 / 16-row x tiles: K not a
# multiple of 16 (the byte-load producer), M of 9, 16 and 17 (two x
# tiles), N one past a tile, K staged in segments (2100 at 16 x rows,
# 4200 at 8)
SHAPES = [(8, 768, 50304), (1, 64, 97), (3, 100, 333), (13, 2100, 777),
          (9, 768, 129), (16, 1000, 257), (17, 768, 1000), (5, 4200, 300)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _inputs(m, k, n):
    """Activations x [m, k] and a frozen int8 table like the engine's
    (N(0, 0.02), per tensor) on the card, with the table's scale."""
    rng = np.random.RandomState(m + k + n)
    w = (rng.randn(n, k) * 0.02).astype(np.float32)
    scale = np.float32(np.abs(w).max())
    q = np.clip(np.round(w / scale * 127), -127, 127).astype(np.int8)
    x = rng.randn(m, k).astype(np.float32)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda(),
            torch.tensor(scale).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dequant_matmul_kernel_matches_plain(m, k, n, per_row):
    _card()
    x, q, s = _inputs(m, k, n)
    if per_row:
        s = q.float().abs().amax(1) / 127.0 * s
    launches = quant_ops.dequant_matmul.launches
    got = quant_ops.dequant_matmul(x, q, s)
    assert quant_ops.dequant_matmul.launches == launches + 1
    want = quant_ops._dequant_matmul_plain(x, q, s.reshape(-1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_w8a8_kernel_bitwise(m, k, n):
    _card()
    x, q, sb = _inputs(m, k, n)
    for sa in (x.abs().max(), x.abs().max() * 0.9):
        for table in (q.t(), q.t().contiguous()):   # in place, K-major
            launches = lowp.w8a8_matmul.launches
            got = lowp.w8a8_matmul(x, table, sb, sa)
            assert lowp.w8a8_matmul.launches == launches + 1
            assert torch.equal(got, lowp._w8a8_plain(x, table, sb, sa))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_table_views_read_in_place(offset):
    """A table with a padded row stride (offset 0: TMA) or an unaligned
    base (offset 1: byte loads) gives the plain version's result."""
    _card()
    x, q, s = _inputs(8, 768, 1000)
    wide = torch.zeros((1000, 800), dtype=torch.int8, device="cuda")
    wide[:, offset:offset + 768] = q
    view = wide[:, offset:offset + 768]
    torch.testing.assert_close(
        quant_ops.dequant_matmul(x, view, s),
        quant_ops._dequant_matmul_plain(x, view, s.reshape(-1)),
        rtol=1e-5, atol=1e-5)
    sa = x.abs().max()
    assert torch.equal(lowp.w8a8_matmul(x, view.t(), s, sa),
                       lowp._w8a8_plain(x, view.t(), s, sa))


@pytest.mark.cuda
def test_serving_head_kernels_repeat_bitwise():
    _card()
    x, q, s = _inputs(8, 768, 50304)
    first = quant_ops.dequant_matmul(x, q, s)
    assert torch.equal(quant_ops.dequant_matmul(x, q, s), first)
    sa = x.abs().max()
    first = lowp.w8a8_matmul(x, q.t(), s, sa)
    assert torch.equal(lowp.w8a8_matmul(x, q.t(), s, sa), first)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(8, 768), (16, 2100)])
def test_serving_head_occupancy(m, k):
    """B7 and B8 build without spills and fit the card at the serving
    shape and at a segmented one."""
    _card()
    for occ in (quant_ops._occupancy(m, k), lowp._w8a8_occupancy(m, k)):
        assert occ["threads"] == 160 and occ["local_bytes"] == 0, occ
        assert occ["blocks_per_sm"] >= 1, occ


@pytest.mark.cuda
def test_w8a8_kernel_rounds_half_to_even():
    _card()
    sa = torch.tensor(3.7)
    x = ((torch.arange(-127, 127) + 0.5) * sa / 127.0).repeat(8, 1).cuda()
    q = torch.randint(-127, 128, (333, x.shape[1]), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0)).cuda()
    sb, sa = torch.tensor(0.05).cuda(), sa.cuda()
    assert torch.equal(lowp.w8a8_matmul(x, q.t(), sb, sa),
                       lowp._w8a8_plain(x, q.t(), sb, sa))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16, 32, 40])
def test_serving_head_rows_independent_of_row_count(m):
    """The speculative verify head projects 8·(k+1) rows where decode
    projects 8: B7 and B8 give every row the bits its own one-row call
    gives it, whatever the number of rows beside it (x tiles of 8 and
    16 rows, one or more of them a block column)."""
    _card()
    x, q, s = _inputs(m, 768, 50304)
    sa = x.abs().max()
    b7 = quant_ops.dequant_matmul(x, q, s)
    b8 = lowp.w8a8_matmul(x, q.t(), s, sa)
    for i in range(m):
        assert torch.equal(b7[i:i + 1], quant_ops.dequant_matmul(
            x[i:i + 1], q, s)), i
        assert torch.equal(b8[i:i + 1], lowp.w8a8_matmul(
            x[i:i + 1], q.t(), s, sa)), i


@pytest.mark.cuda
def test_flash_forward_rows_independent_of_batch():
    """B1 in eval (dropout 0) at the ERNIE shape gives each (b, h) the
    same bits whatever the batch it sits in: the dynamic batcher pads a
    sample into any bucket of 1-32."""
    _card()
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn((32, 512, 3, 12, 64), generator=gen).to(
        torch.bfloat16).cuda()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    full = fused_ops.flash_attention(q, k, v)
    for b in (1, 2, 3, 4, 8, 16, 31):
        got = fused_ops.flash_attention(q[-b:], k[-b:], v[-b:])
        assert torch.equal(got, full[-b:]), b


# B9: (m, k, n) ragged against its 128 x 128 x 128 tiles (K off the
# 128-deep steps, M and N just past a tile edge), ERNIE-like ones
SMM_SHAPES = [(1, 100, 2), (7, 100, 3), (33, 768, 333), (130, 768, 2304),
              (300, 3072, 768), (256, 768, 1024), (129, 129, 257),
              (257, 200, 129), (129, 3000, 130)]


def _smm_case(m, k, n, a_dtype, b_dtype, chunk_view):
    gen = torch.Generator().manual_seed(m * 7 + k + n)
    a = (torch.randn((m, k), generator=gen) * 2.0).to(a_dtype).cuda()
    if chunk_view:      # the loss's [cv, H] chunk read as [H, cv]
        b = (torch.randn((n, k), generator=gen) * 0.05).to(b_dtype).cuda().t()
    else:               # a Linear weight [in, out]
        b = (torch.randn((k, n), generator=gen) * 0.05).to(b_dtype).cuda()
    return a, b, lowp.amax_of(a), lowp.amax_of(b)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_view", [False, True])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float16, torch.float32),
                                    (torch.float16, torch.float16)])
@pytest.mark.parametrize("m,k,n", SMM_SHAPES)
def test_scaled_matmul_kernel_int8_bitwise(m, k, n, dtypes, chunk_view):
    _card()
    a, b, sa, sb = _smm_case(m, k, n, *dtypes, chunk_view)
    for s in (sa, sa * 0.7):        # the abs-max, and a delayed one that clips
        launches = lowp.scaled_matmul.launches
        got = lowp._smm_kernel(a, b, s, sb, "int8")
        assert lowp.scaled_matmul.launches == launches + 1
        assert torch.equal(got, lowp._smm_plain(a, b, s, sb, "int8"))


def _fp8_tol(a, b, sa, sb):
    qa = lowp._quant_f8(a, sa).double().abs()
    qb = lowp._quant_f8(b, sb).double().abs()
    epi = float(sa) * float(sb) / 448.0 ** 2
    return 4 * a.shape[1] * 2.0 ** -24 * (qa @ qb) * epi


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_view", [False, True])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m,k,n", SMM_SHAPES)
def test_scaled_matmul_kernel_fp8_within_tolerance(m, k, n, dtypes,
                                                   chunk_view):
    _card()
    a, b, sa, sb = _smm_case(m, k, n, *dtypes, chunk_view)
    got = lowp._smm_kernel(a, b, sa, sb, "fp8").double()
    want = lowp._smm_plain(a, b, sa, sb, "fp8").double()
    assert bool(((got - want).abs() <= _fp8_tol(a, b, sa, sb) + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_scaled_matmul_kernel_codes_bitwise(qdtype):
    """An identity b (its code is qmax, exact) leaves one exact product
    per output: the kernel's quantization of a, at the rounding ties
    of both formats, at saturation and in e4m3's subnormals, bit for
    bit."""
    _card()
    k = 256
    sa = torch.tensor(3.7)
    ties = (torch.arange(-127, 129) + 0.5) * sa / 127.0
    f8 = torch.tensor([2.0 ** -9, 3 * 2.0 ** -10, 1.0625, 1.1875, 300.0,
                       -460.0, 449.0, 1e-7, 0.0, -0.0])
    x = torch.cat([ties[:k - f8.numel()], f8 * sa / 448.0]).repeat(3, 1)
    x[1] *= -1
    x[2] = torch.randn(k, generator=torch.Generator().manual_seed(1)) * 4
    a, eye, sa = x.cuda(), torch.eye(k).cuda(), sa.cuda()
    one = torch.tensor(1.0).cuda()
    got = lowp._smm_kernel(a, eye, sa, one, qdtype)
    assert torch.equal(got, lowp._smm_plain(a, eye, sa, one, qdtype))
    got = lowp._smm_kernel(a.bfloat16(), eye, sa, one, qdtype)
    assert torch.equal(got, lowp._smm_plain(a.bfloat16(), eye, sa, one,
                                            qdtype))


@pytest.mark.cuda
def test_scaled_matmul_routes_cuda_tensors_to_the_kernel():
    _card()
    a = torch.randn(5, 64).cuda().requires_grad_(True)
    b = torch.randn(64, 9).cuda().requires_grad_(True)
    launches = lowp.scaled_matmul.launches
    out = lowp.scaled_matmul(a, b, qdtype="fp8")
    out.sum().backward()
    assert lowp.scaled_matmul.launches == launches + 1
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    with pytest.raises(TypeError, match="float16"):
        lowp._smm_kernel(a.detach().double(), b.detach(), lowp.amax_of(a),
                         lowp.amax_of(b), "int8")


# flash attention: (b, h, sq, sk, d) — ragged against the 64-row tiles,
# sq != sk (bottom-right causal alignment), every supported head dim
FLASH_SHAPES = [(1, 2, 70, 70, 32), (2, 3, 9, 21, 64), (1, 2, 21, 9, 64),
                (2, 2, 130, 70, 128), (2, 3, 128, 128, 64)]


# bf16 (B1 and B3 on the tensor cores): rows ragged against the tiles
# (1, 63, 65, 200), sq != sk both ways, every head dim; `packed` hands
# over q, k, v as the [b, h, s, d] views of one [b, s, 3, h, d]
# projection and the output gradient as a transposed [b, s, h, d]
FLASH_BF16_CASES = [((1, 2, 1, 1, 64), False), ((1, 2, 63, 65, 32), False),
                    ((2, 2, 65, 63, 128), False), ((1, 3, 1, 200, 64), False),
                    ((2, 2, 200, 63, 32), False), ((1, 2, 65, 200, 128), False),
                    ((2, 3, 200, 200, 32), True), ((2, 3, 200, 200, 64), True),
                    ((1, 2, 200, 200, 128), True)]


def _flash_case(b, h, sq, sk, d, dtype, causal, dropout_p, seed=3,
                packed=False):
    gen = torch.Generator().manual_seed(b * 1000 + sq * 10 + sk + d)
    if packed:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen).to(dtype).cuda()
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.randn((b, sq, h, d), generator=gen).to(
            dtype).cuda().transpose(1, 2)
    else:
        q, k, v = (torch.randn((b, h, n, d), generator=gen).to(dtype).cuda()
                   for n in (sq, sk, sk))
        do = torch.randn((b, h, sq, d), generator=gen).to(dtype).cuda()
    sd = torch.tensor(seed, device="cuda")
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    before = dict(fused_ops.flash_attention.launches)
    o = fused_ops.flash_attention(qg, kg, vg, sd, is_causal=causal,
                                  dropout_p=dropout_p)
    o.backward(do)
    torch.cuda.synchronize()
    after = fused_ops.flash_attention.launches
    assert all(after[n] == before[n] + 1 for n in ("B1", "B2", "B3"))
    scale = 1.0 / d ** 0.5
    to3 = fused_ops._to3
    o_p, lse_p = fused_ops._flash_fwd_plain(to3(q), to3(k), to3(v), sd,
                                            scale, causal, dropout_p)
    grads_p = fused_ops._flash_bwd_plain(
        to3(q), to3(k), to3(v), o_p, lse_p, to3(do), sd, scale, causal,
        dropout_p)
    return (o, qg.grad, kg.grad, vg.grad), (o_p, *grads_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,sq,sk,d", FLASH_SHAPES)
def test_flash_kernels_match_plain_f32(b, h, sq, sk, d, causal,
                                       dropout_p):
    _card()
    got, want = _flash_case(b, h, sq, sk, d, torch.float32, causal,
                            dropout_p)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-5 if i == 0 else 2e-4
        torch.testing.assert_close(g.reshape(w.shape), w, rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,packed", FLASH_BF16_CASES)
def test_flash_kernels_match_plain_bf16(shape, packed, causal, dropout_p):
    _card()
    got, want = _flash_case(*shape, torch.bfloat16, causal, dropout_p,
                            packed=packed)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.reshape(w.shape).float(), w.float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,packed", FLASH_BF16_CASES)
def test_flash_kernels_match_plain_f16(shape, packed, causal, dropout_p):
    """The f16 instantiation of B1-B3: within the bf16 gate scaled by
    the formats' epsilons (2e-2 x 2^-10 / 2^-7)."""
    _card()
    got, want = _flash_case(*shape, torch.float16, causal, dropout_p,
                            packed=packed)
    for g, w in zip(got, want):
        assert g.dtype == torch.float16
        torch.testing.assert_close(g.reshape(w.shape).float(), w.float(),
                                   rtol=2.5e-3, atol=2.5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_flash_bf16_backward_repeats_bitwise(dropout_p):
    """B2 and B3 own their output tiles (no atomics): the same backward
    twice gives the same dq, dk, dv bit for bit."""
    _card()
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((2, 3, 200, 64), generator=gen).to(
        torch.bfloat16).cuda() for _ in range(3))
    do = torch.randn((2, 3, 200, 64), generator=gen).to(torch.bfloat16).cuda()
    sd = torch.tensor(5, device="cuda")
    grads = []
    for _ in range(2):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        fused_ops.flash_attention(*leaves, sd, is_causal=True,
                                  dropout_p=dropout_p).backward(do)
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_dropout_mask_bitwise(p):
    _card()
    seed = torch.tensor(987654321, device="cuda")
    got = fused_ops._keep_mask_kernel(seed, 6, 70, 130, p)
    want = fused_ops._keep_mask(seed, 6, 70, 130, p)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_dropout_at_a_batch_head_offset_matches_plain(dtype):
    """The kernels hash the global batch-head index (rows 1-2 and heads
    3-5 of 6 here): the mask and B1-B3 against the plain versions at
    the same offset."""
    _card()
    seed = torch.tensor(31337, device="cuda")
    off = (1, 3, 6)
    got = fused_ops._keep_mask_kernel(seed, 2 * 3, 70, 130, 0.1, 3, off)
    want = fused_ops._keep_mask(seed, 2 * 3, 70, 130, 0.1, 3, off)
    assert torch.equal(got, want)
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((2, 3, 70, 64), generator=gen).to(dtype).cuda()
               for _ in range(3))
    do = torch.randn((2, 3, 70, 64), generator=gen).to(dtype).cuda()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = fused_ops.flash_attention(*leaves, seed, dropout_p=0.1,
                                  bh_offset=off)
    o.backward(do)
    to3 = fused_ops._to3
    args = [to3(t) for t in (q, k, v)]
    o_p, lse = fused_ops._flash_fwd_plain(*args, seed, 0.125, False, 0.1, 3,
                                          off)
    g_p = fused_ops._flash_bwd_plain(*args, o_p, lse, to3(do), seed, 0.125,
                                     False, 0.1, 3, off)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip([o, *(t.grad for t in leaves)], [o_p, *g_p]):
        torch.testing.assert_close(a.reshape(b.shape).float(), b.float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_rejects_unsupported_head_dim():
    _card()
    q = torch.randn((1, 1, 8, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fused_ops.flash_attention(q, q, q)


# fused LM-head loss: (n, h, v, masked share) — ragged against the 32-
# and 64-row tiles, vocab tails, heavy masking, every row ignored
LCE_SHAPES = [(37, 64, 301, 0.3), (130, 128, 1000, 0.85),
              (300, 256, 777, 0.5), (64, 768, 2000, 1.0)]


def _lce_case(n, h, v, masked, dtype, seed=0):
    rng = np.random.RandomState(seed + n + h + v)
    x = torch.from_numpy(rng.randn(n, h).astype(np.float32) * 0.5)
    w = torch.from_numpy(rng.randn(v, h).astype(np.float32) * 0.1)
    lbl = rng.randint(0, v, n)
    lbl[rng.rand(n) < masked] = -100
    g = torch.from_numpy(rng.rand(n).astype(np.float32))
    g[torch.from_numpy(lbl) == -100] = 0.0
    return (x.to(dtype).cuda(), w.to(dtype).cuda(),
            torch.from_numpy(lbl).cuda(), g.cuda())


def _lce_both(x, w, lbl, g):
    before = dict(fused_loss.launches)
    nll, lse = fused_loss._fwd_kernel(x, w, lbl)
    dx, dw = fused_loss._bwd_kernel(x, w, lbl, lse, g)
    torch.cuda.synchronize()
    assert all(fused_loss.launches[k] == before[k] + 1
               for k in ("B4", "B5", "B6"))
    nll_p, lse_p = fused_loss._fwd_plain(x, w, lbl, 128)
    dx_p, dw_p = fused_loss._bwd_plain(x, w, lbl, lse_p, g, 128)
    return (nll, lse, dx, dw), (nll_p, lse_p, dx_p, dw_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,v,masked", LCE_SHAPES)
def test_fused_loss_kernels_match_plain_f32(n, h, v, masked):
    _card()
    got, want = _lce_both(*_lce_case(n, h, v, masked, torch.float32))
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,v", [(333, 768, 18000), (70, 64, 301)])
def test_fused_loss_kernels_match_plain_bf16(n, h, v):
    _card()
    got, want = _lce_both(*_lce_case(n, h, v, 0.85, torch.bfloat16))
    for gt, wt in zip(got[:2], want[:2]):
        torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-4)
    for gt, wt in zip(got[2:], want[2:]):
        gt, wt = gt.float(), wt.float()
        # one bf16 ulp of each element (of the largest one near 0)
        ulp = torch.maximum(wt.abs(), wt.abs().max() * 2 ** -8) * 2 ** -7
        assert bool(((gt - wt).abs() <= ulp).all()), \
            float(((gt - wt).abs() / ulp).max())


# B4 in bf16 (lse_kernel: 128 owned token rows, 64 at H 1024, vocab
# tiles of 128): (n, h, v, masked) at every hidden size, N off the
# 128-row tiles, vocab tails shorter than a tile (V 129: one column),
# every label ignored, the ERNIE head; every case with a valid label
# also puts one in the last, partial vocab tile
LSE_BF16_CASES = [(37, 64, 301, 0.3), (300, 64, 129, 0.0),
                  (130, 128, 1000, 0.85), (300, 256, 777, 1.0),
                  (200, 512, 300, 0.5), (129, 768, 65, 0.0),
                  (257, 768, 4001, 0.5), (70, 1024, 513, 0.5),
                  (300, 1024, 129, 0.3), (16384, 768, 18000, 0.85)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,v,masked", LSE_BF16_CASES)
def test_fused_loss_fwd_bf16_matches_plain_and_repeats(n, h, v, masked):
    _card()
    x, w, lbl, _ = _lce_case(n, h, v, masked, torch.bfloat16)
    if masked < 1.0:
        lbl[-1] = v - 1
    before = fused_loss.launches["B4"]
    nll, lse = fused_loss._fwd_kernel(x, w, lbl)
    again = fused_loss._fwd_kernel(x, w, lbl)
    assert fused_loss.launches["B4"] == before + 2
    nll_p, lse_p = fused_loss._fwd_plain(x, w, lbl, 1024)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    valid = lbl != -100
    torch.testing.assert_close(nll[valid], nll_p[valid], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(again[0], nll) and torch.equal(again[1], lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_kernels_repeat_bitwise(dtype):
    _card()
    x, w, lbl, g = _lce_case(257, 128, 3001, 0.5, dtype)
    first = _lce_both(x, w, lbl, g)[0]
    second = _lce_both(x, w, lbl, g)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# bf16 ragged against B6's 64-row vocab and token tiles (and B5's 32-row
# tiles): every hidden size, V and N not multiples of 64 or 128, every
# label ignored; all but the first and the last split vocab tiles over
# the tokens on a 132-SM card (`dw_split`)
LCE_BF16_RAGGED = [(37, 64, 301, 0.3), (300, 64, 301, 0.3),
                   (130, 128, 1000, 0.85), (300, 256, 777, 1.0),
                   (200, 512, 300, 0.5), (129, 768, 65, 0.0),
                   (65, 768, 4001, 0.5), (70, 1024, 513, 0.5)]


def _lce_exact_case(n, h, v, masked, dtype=torch.bfloat16):
    """bf16 x in quarters and w in sixteenths of -2..2: every score is
    exact in f32 in any order of its sums, so given one lse the kernels
    and the plain version round the same d to bf16 and dx / dw differ
    only by the order of their own f32 sums. (With arbitrary operands
    the two sides' scores differ in their last bits, a d on a bf16
    rounding boundary can round either way, and where dw's terms cancel
    that moves an element by more than one of its own ulps.)"""
    rng = np.random.RandomState(n + h + v)
    x = torch.from_numpy(rng.randint(-2, 3, (n, h)) / 4.0)
    w = torch.from_numpy(rng.randint(-2, 3, (v, h)) / 16.0)
    lbl = rng.randint(0, v, n)
    lbl[rng.rand(n) < masked] = -100
    g = torch.from_numpy(rng.rand(n).astype(np.float32))
    g[torch.from_numpy(lbl) == -100] = 0.0
    return (x.to(dtype).cuda(), w.to(dtype).cuda(),
            torch.from_numpy(lbl).cuda(), g.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,v,masked", LCE_BF16_RAGGED)
def test_fused_loss_f16_ragged_within_one_ulp(n, h, v, masked):
    """The f16 instantiation of B4-B6 on exact scores: nll / lse within
    1e-4, dx / dw within one f16 ulp (at least the subnormal spacing)."""
    _card()
    x, w, lbl, g = _lce_exact_case(n, h, v, masked, torch.float16)
    nll, lse = fused_loss._fwd_kernel(x, w, lbl)
    nll_p, lse_p = fused_loss._fwd_plain(x, w, lbl, 128)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    dx, dw = fused_loss._bwd_kernel(x, w, lbl, lse, g)
    dx_p, dw_p = fused_loss._bwd_plain(x, w, lbl, lse, g, 128)
    for gt, wt in ((dx, dx_p), (dw, dw_p)):
        assert gt.dtype == torch.float16
        gt, wt = gt.float(), wt.float()
        ulp = (torch.maximum(wt.abs(), wt.abs().max() * 2 ** -8) *
               2 ** -10).clamp_min(2.0 ** -24)
        assert bool(((gt - wt).abs() <= ulp).all()), \
            float(((gt - wt).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,v,masked", LCE_BF16_RAGGED)
def test_fused_loss_bf16_ragged_within_one_ulp_and_repeats(n, h, v, masked):
    _card()
    x, w, lbl, g = _lce_exact_case(n, h, v, masked)
    nll, lse = fused_loss._fwd_kernel(x, w, lbl)
    before = dict(fused_loss.launches)
    dx, dw = fused_loss._bwd_kernel(x, w, lbl, lse, g)
    assert all(fused_loss.launches[k] == before[k] + 1 for k in ("B5", "B6"))
    dx_p, dw_p = fused_loss._bwd_plain(x, w, lbl, lse, g, 128)
    for gt, wt in ((dx, dx_p), (dw, dw_p)):
        gt, wt = gt.float(), wt.float()
        # one bf16 ulp of each element (of the largest one near 0)
        ulp = torch.maximum(wt.abs(), wt.abs().max() * 2 ** -8) * 2 ** -7
        assert bool(((gt - wt).abs() <= ulp).all()), \
            float(((gt - wt).abs() / ulp).max())
    if masked == 1.0:
        assert float(dw.float().abs().max()) == 0.0
    again = fused_loss._bwd_kernel(x, w, lbl, lse, g)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.cuda
def test_fused_loss_dx_bf16_ernie_shape_repeats_bitwise():
    """B5 at the ERNIE head (x [16384, 768], w [18000, 768] bf16, 85% of
    the labels ignored): one launch each, every dx element summed by one
    thread in a fixed vocab order, so two launches agree bit for bit;
    within one bf16 ulp of the plain version."""
    _card()
    x, w, lbl, g = _lce_case(16384, 768, 18000, 0.85, torch.bfloat16)
    lbl32 = lbl.to(torch.int32)
    _nll, lse = fused_loss._fwd_kernel(x, w, lbl)
    before = fused_loss.launches["B5"]
    first = fused_loss._bwd_dx_kernel(x, w, lbl32, lse, g)
    second = fused_loss._bwd_dx_kernel(x, w, lbl32, lse, g)
    assert fused_loss.launches["B5"] == before + 2
    assert torch.equal(first, second)
    want = fused_loss._bwd_plain(x, w, lbl, lse, g, 1024)[0].float()
    ulp = torch.maximum(want.abs(), want.abs().max() * 2 ** -8) * 2 ** -7
    assert bool(((first.float() - want).abs() <= ulp).all())


@pytest.mark.cuda
def test_fused_loss_op_all_rows_ignored_and_rejects_bad_hidden():
    _card()
    x, w, lbl, _ = _lce_case(40, 64, 301, 1.0, torch.float32)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss = fused_loss.fused_linear_cross_entropy(xg, wg, lbl)
    loss.backward()
    assert float(loss) == 0.0
    assert float(xg.grad.abs().max()) == 0.0
    assert float(wg.grad.abs().max()) == 0.0
    with pytest.raises(ValueError, match="hidden size"):
        fused_loss._fwd_kernel(torch.zeros((4, 96), device="cuda"),
                               torch.zeros((9, 96), device="cuda"),
                               torch.zeros((4,), dtype=torch.long,
                                           device="cuda"))


# B10: (n, c, h, w, o, k, s, pad) — ragged pixel counts against the
# 128-pixel tiles, Ce 12 (the s2d stem) and odd (padded to 8 by
# `_lower`), O odd (weights padded to 8 columns) and past one 64-wide
# tile, 1x1 / 3x3 / 4x4 / 7x7 at stride 1 and 2; then ResNet-50's
# kinds at M not a multiple of 128: a 3x3 stride 2 on 128 channels
# (whole dead chunks skipped), a 1x1 of K 64 into O 256 (one chunk,
# 128-wide tiles), a 1x1 into O 2048 (K 512: 128-wide tiles) and the
# 256-wide tiles that O over 128 with 16 walked chunks or more choose: a
# 3x3 on 128 channels into 256 at stride 1 (18 chunks) and stride 2 (18
# of 32 chunks live)
CONV_SHAPES = [(2, 64, 9, 11, 128, 1, 1, 0), (3, 12, 17, 15, 64, 4, 1, 0),
               (2, 5, 9, 10, 10, 3, 1, 1), (1, 24, 13, 11, 72, 3, 2, 1),
               (2, 3, 15, 14, 67, 7, 2, 3), (2, 40, 8, 9, 200, 1, 2, 0),
               (2, 128, 15, 13, 96, 3, 2, 1), (3, 64, 14, 15, 256, 1, 1, 0),
               (2, 512, 7, 7, 2048, 1, 1, 0), (2, 128, 15, 13, 256, 3, 1, 1),
               (1, 128, 17, 15, 256, 3, 2, 1)]


def _conv_case(n, c, h, w, o, k, s, pad, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed + n + c + h + o + k)
    x = torch.randn((n, c, h, w), generator=gen).to(dtype)
    wt = (torch.randn((o, c, k, k), generator=gen) / (c * k * k) ** 0.5
          ).to(dtype)
    plan = fused_conv._plan(x.shape, wt.shape, (s, s), ((pad, pad),) * 2)
    xp, wk = fused_conv._lower(x.cuda(), wt.cuda(), plan)
    g = torch.rand((o,), generator=gen).cuda() + 0.5
    b = torch.randn((o,), generator=gen).cuda() * 0.1
    res = torch.randn((n, plan.ho, plan.wo, o), generator=gen).to(
        dtype).cuda()
    return plan, xp, wk, g, b, res


def _assert_conv_close(got, want, bf16):
    """One ulp of the 16-bit dtype (`bf16` True: bfloat16, or the
    dtype itself), rtol 1e-5 in f32."""
    low = got.dtype if got.dtype in (torch.bfloat16, torch.float16) \
        else (torch.bfloat16 if bf16 else None)
    got, want = got.float(), want.float()
    if low is not None:
        eps = 2 ** -10 if low == torch.float16 else 2 ** -7
        ulp = (torch.maximum(want.abs(), want.abs().max() * 2 ** -8) *
               eps).clamp_min(2.0 ** -24)
        assert bool(((got - want).abs() <= ulp).all()), \
            float(((got - want).abs() / ulp).max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,c,h,w,o,k,s,pad", CONV_SHAPES)
def test_conv_kernel_epilogues_match_plain(n, c, h, w, o, k, s, pad,
                                           dtype):
    _card()
    plan, xp, wk, g, b, res = _conv_case(n, c, h, w, o, k, s, pad, dtype)
    bf16 = dtype != torch.float32
    legs = [dict(), dict(moments=True), dict(g=g, b=b, act="relu"),
            dict(g=g, b=b, res=res, act="identity"),
            dict(g=g, b=b, res=res, act="relu")]
    for leg in legs:
        before = fused_conv.LAUNCHES
        got = fused_conv._conv_kernel(xp, wk, plan, **leg)
        torch.cuda.synchronize()
        assert fused_conv.LAUNCHES == before + 1
        want = fused_conv._conv_plain(xp, wk, plan, **leg)
        _assert_conv_close(got[0], want[0], bf16)
        if leg.get("moments"):
            for gm, wm in zip(got[1:], want[1:]):
                torch.testing.assert_close(
                    gm, wm, rtol=1e-4 if bf16 else 1e-5,
                    atol=(1e-4 if bf16 else 1e-5) * float(wm.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,o,k,s,pad", CONV_SHAPES[2:])
def test_conv_grads_through_parity_planes_match_plain(n, c, h, w, o, k, s,
                                                      pad, dtype):
    """_ConvCore forward and backward on the card (B10 for z and for
    every dx plane) against the same on the CPU (the plain version)."""
    _card()
    gen = torch.Generator().manual_seed(k * 7 + s)
    x = torch.randn((n, c, h, w), generator=gen).to(dtype)
    wt = (torch.randn((o, c, k, k), generator=gen) / (c * k * k) ** 0.5
          ).to(dtype)
    cfg = (s, pad, pad, pad, pad)
    plan = fused_conv._plan(x.shape, wt.shape, (s, s), ((pad, pad),) * 2)
    dz = torch.randn((n, o, plan.ho, plan.wo), generator=gen).to(dtype)
    outs, launched = {}, {}
    for dev in ("cuda", "cpu"):
        xl = x.to(dev).requires_grad_(True)
        wl = wt.to(dev).requires_grad_(True)
        before = fused_conv.LAUNCHES
        z = fused_conv._ConvCore.apply(xl, wl, cfg, False)
        z.backward(dz.to(dev))
        torch.cuda.synchronize()
        launched[dev] = fused_conv.LAUNCHES - before
        outs[dev] = [t.detach().cpu() for t in (z, xl.grad)]
    planes = sum(
        fused_conv._taps_1d(k, s, a, pad) is not None
        and fused_conv._taps_1d(k, s, bb, pad) is not None
        for a in range(s) for bb in range(s))
    assert launched == {"cuda": 1 + planes, "cpu": 0}
    bf16 = dtype == torch.bfloat16
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _assert_conv_close(got, want, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,o,k,s,pad",
                         [CONV_SHAPES[i] for i in (1, 2, 3, 7, 9, 10)])
def test_conv_kernel_every_tile_matches_plain(n, c, h, w, o, k, s, pad):
    """Each of the bf16 kernel's three tile widths, at shapes whose O and
    K choose it (64: the stem and O 10; 128: O 72 at stride 2 and the
    one-chunk 1x1 into O 256; 256: the two 3x3s into O 256): y within one
    bf16 ulp, the moments within 1e-4, and a second launch equal bit for
    bit."""
    _card()
    plan, xp, wk, g, b, res = _conv_case(n, c, h, w, o, k, s, pad,
                                         torch.bfloat16)
    for leg in (dict(moments=True), dict(g=g, b=b, res=res, act="relu")):
        got = fused_conv._conv_kernel(xp, wk, plan, **leg)
        again = fused_conv._conv_kernel(xp, wk, plan, **leg)
        want = fused_conv._conv_plain(xp, wk, plan, **leg)
        _assert_conv_close(got[0], want[0], True)
        for gm, wm in zip(got[1:], want[1:]):
            torch.testing.assert_close(gm, wm, rtol=1e-4,
                                       atol=1e-4 * float(wm.abs().max()))
        assert all(torch.equal(a, c_) for a, c_ in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,o,k,s,pad", CONV_SHAPES)
def test_conv_kernel_bf16_repeats_bitwise(n, c, h, w, o, k, s, pad):
    """The bf16 moments sum in a fixed order (no atomics): two launches
    agree bit for bit, y and both moment rows."""
    _card()
    plan, xp, wk, _g, _b, _res = _conv_case(n, c, h, w, o, k, s, pad,
                                            torch.bfloat16)
    first = fused_conv._conv_kernel(xp, wk, plan, moments=True)
    second = fused_conv._conv_kernel(xp, wk, plan, moments=True)
    assert all(torch.equal(a, c_) for a, c_ in zip(first, second))


@pytest.mark.cuda
def test_conv_launch_count_and_bitwise_repeat():
    _card()
    plan, xp, wk, g, b, res = _conv_case(2, 64, 14, 14, 128, 3, 1, 1,
                                         torch.bfloat16)
    first = fused_conv._conv_kernel(xp, wk, plan, moments=True)
    second = fused_conv._conv_kernel(xp, wk, plan, moments=True)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    x = torch.randn((2, 24, 13, 11), device="cuda").requires_grad_(True)
    w = torch.randn((40, 24, 3, 3), device="cuda").requires_grad_(True)
    before = fused_conv.LAUNCHES
    z = fused_conv._ConvCore.apply(x, w, (2, 1, 1, 1, 1), False)
    z.sum().backward()
    # one forward launch, four parity planes of dx
    assert fused_conv.LAUNCHES == before + 5


# ---------------------------------------------------------------------------
# the serving fleet on the card: B7 inside replica threads
# ---------------------------------------------------------------------------


def _tiny_gpt(device):
    """The parity tests' tiny GPT (vocab 97, hidden 64, 2 layers) on
    `device`, weights drawn with numpy from seed 0 at 0.1 scale."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import gpt

    cfg = gpt.GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=64, dropout=0.0,
                        attn_dropout=0.0, use_parallel=False)
    model = gpt.GPTForPretraining(cfg, device=device)
    rng = np.random.RandomState(0)
    vals = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if len(shape) >= 2:
            v = rng.randn(*shape) * 0.1
        elif "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        vals[name] = v.astype(np.float32)
    weights.from_paddle_tpu_values(vals, model)
    return model


def _recording_fleet(monkeypatch, device, name):
    """A started 2-replica int8 Router whose engines keep, per prompt,
    the logits row behind each greedy pick."""
    from paddle_tpu_torch.serving import Router, SlotEngine, fleet

    rows = {}

    class Recording(SlotEngine):
        def _pick(self, slot):
            key = slot.req.payload.tobytes()
            rows.setdefault(key, []).append(slot.next_logits.copy())
            return super()._pick(slot)

    monkeypatch.setattr(fleet, "SlotEngine", Recording)
    router = Router(_tiny_gpt(device), replicas=2, device=device,
                    engine_kw=dict(max_slots=2, block_size=8,
                                   quantize=True),
                    hedge=False, liveness_timeout_s=60.0, name=name)
    return router.start(), rows


@pytest.mark.cuda
def test_fleet_on_card_matches_cpu_fleet(monkeypatch):
    """A 2-replica int8 fleet on the card (B7 in both replica threads)
    against the same fleet on the CPU (B7's plain version): equal greedy
    tokens, except at a near-tie — where the two devices' logits differ
    by at least half the CPU row's top-2 margin a flip is legitimate
    and the sequences part there."""
    _card()
    prompts = [np.random.RandomState(s).randint(1, 97, (n,)).astype(
        np.int32) for s, n in ((3, 5), (50, 20), (9, 12), (11, 7))]
    outs, rows = {}, {}
    for dev in ("cuda", "cpu"):
        router, rows[dev] = _recording_fleet(monkeypatch, dev, "cf")
        try:
            futs = [router.submit(p, max_new_tokens=10) for p in prompts]
            outs[dev] = [np.asarray(f.result(120))[p.size:]
                         for p, f in zip(prompts, futs)]
        finally:
            router.shutdown(drain=True, timeout=60.0)
    compared = total = 0
    for p, c, q in zip(prompts, outs["cuda"], outs["cpu"]):
        rc, rq = rows["cuda"][p.tobytes()], rows["cpu"][p.tobytes()]
        stop = q.size
        for j in range(q.size):
            if c[j] != q[j]:
                top2 = np.sort(rq[j])[-2:]
                gap = float(np.abs(rc[j] - rq[j]).max())
                assert top2[1] - top2[0] <= 2 * gap, (j, c, q)
                stop = j
                break
        compared, total = compared + stop, total + q.size
    assert compared >= 0.75 * total, (compared, total)


@pytest.mark.cuda
def test_fleet_launch_counts_equal_summed_steps(monkeypatch):
    """B7's launch counter across two replica threads stepping at once:
    exactly one launch per step of either replica plus one per warm-up
    (no count lost to a racing read-add-store)."""
    _card()
    quant_ops.dequant_matmul.launches = 0
    router, _ = _recording_fleet(monkeypatch, "cuda", "lc")
    try:
        assert quant_ops.dequant_matmul.launches == 2   # two warm-ups
        futs = [router.submit(np.random.RandomState(i).randint(
            1, 97, (6 + i,)).astype(np.int32), max_new_tokens=12)
            for i in range(8)]
        for f in futs:
            f.result(120)
        steps = router.metrics.get("steps")
        assert all(r.engine.heartbeats > 0
                   for r in router.replica_set.replicas)
    finally:
        router.shutdown(drain=True, timeout=60.0)
    assert steps > 0
    assert quant_ops.dequant_matmul.launches == steps + 2
