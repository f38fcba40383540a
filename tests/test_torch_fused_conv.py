"""Port parity: paddle_tpu_torch's fused conv (B10's plain version, its
lowering and its VJPs), batch norm, pooling and Momentum against
paddle_tpu's default path on the CPU, which sends every conv through
``_conv_core`` / ``_conv_affine`` with lax convs (not the Pallas
interpret mode, ``PADDLE_TPU_CONV_FORCE=pallas``, which fails under this
jax). Inputs are numpy arrays from fixed seeds.

Tolerances, float32: ``|port - ref| <= 1e-5 * (|ref| + max|ref|)``
elementwise, i.e. 1e-5 relative to each tensor's scale (the same f32
arithmetic summed in other orders: lax's conv against torch's, the
parity-plane dx against lax's transposed conv, the batch-norm sums).

bf16 (one case, amp's layout: bf16 x / w / residual, f32 BN
parameters): the kernel and its plain version apply the epilogue to
the UNROUNDED f32 accumulator, the reference's lax path to z rounded to
bf16 first (see ``paddle_tpu_torch/ops/fused_conv.py``). Measured on
this case: the new running mean and variance differ by 1.1e-4 and
5.2e-5 of their largest element (the batch moments of rounded and
unrounded z), and y differs in 129 (train) and 418 (eval) of 3168
elements by at most one bf16 ulp (0.0156 below |y| = 4, a double
rounding against a single one). So y is held within 2^-7 of each
element plus 2^-8 of the largest (one ulp), the stats within 2e-4.

Momentum (heavy ball and Nesterov, coupled L2 decay) runs three steps
of a small classifier through both packages' engines, then a fourth in
a fresh port engine resumed from the reference's parameters and
velocities: losses, parameters and velocities within rtol 1e-6
(elementwise f32 in the same order; the only sums are the forward's).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import engine as jengine
from paddle_tpu.ops import fused_conv as jfc
from paddle_tpu.ops import nn_ops as jnn_ops

from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.ops import fused_conv as tfc
from paddle_tpu_torch.ops import nn_ops as tnn_ops


def _close(got, want, rtol=1e-5, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


# ---------------------------------------------------------------------------
# the plain B10 through the lowering and _ConvCore's backward
# ---------------------------------------------------------------------------

# tests/test_fused_conv.py's plan space: (n, c, h, w, o, k, s, pads) —
# 1x1 s1/s2, 3x3 s1/s2 (parity planes), the 7x7 s2 vanilla stem, the
# 4x4 s1 space-to-depth stem, even-k stride 2 with asymmetric padding
CONV_CASES = [
    (2, 8, 9, 11, 16, 1, 1, ((0, 0), (0, 0))),
    (2, 8, 9, 11, 16, 1, 2, ((0, 0), (0, 0))),
    (2, 8, 9, 11, 16, 3, 1, ((1, 1), (1, 1))),
    (2, 8, 10, 9, 16, 3, 2, ((1, 1), (1, 1))),
    (1, 3, 15, 14, 8, 7, 2, ((3, 3), (3, 3))),
    (2, 12, 12, 12, 8, 4, 1, ((0, 0), (0, 0))),
    (1, 4, 8, 8, 8, 2, 2, ((0, 1), (1, 0))),
]


@pytest.mark.parametrize("n,c,h,w,o,k,s,pads", CONV_CASES,
                         ids=[f"k{k}s{s}c{c}" for _, c, _, _, _, k, s, _
                              in CONV_CASES])
def test_conv_core_matches_reference(n, c, h, w, o, k, s, pads):
    rng = np.random.default_rng(0)
    x = _rand(rng, (n, c, h, w))
    wt = _rand(rng, (o, c, k, k), 0.1)
    cfg = (s,) + tuple(pads[0]) + tuple(pads[1])

    def loss(fn):
        return lambda xx, ww: jnp.sum(jnp.sin(fn(xx, ww)))

    core = lambda xx, ww: jfc._conv_core(cfg, False, xx, ww)  # noqa: E731
    lax_conv = lambda xx, ww: jfc._conv_ref(xx, ww, (s, s), pads)  # noqa
    ref = core(jnp.asarray(x), jnp.asarray(wt))
    # the gradients are held against lax's own AD of the conv, as in
    # tests/test_fused_conv.py, and against the reference's _conv_core
    # backward where that is right: on the CPU it hands the asymmetric
    # k2s2 case's negative plane pads to XLA's conv, which then reads
    # past its input (garbage and NaN in dx's last column, where the
    # exact gradient is 0)
    oracles = [lax_conv] + ([core] if pads[0] == pads[1] and
                            pads[0][0] == pads[0][1] else [])
    grads = [jax.grad(loss(f), (0, 1))(jnp.asarray(x), jnp.asarray(wt))
             for f in oracles]
    tx, tw = _leaf(x), _leaf(wt)
    before = tfc.LAUNCHES
    y = tfc._ConvCore.apply(tx, tw, cfg, False)
    y.sin().sum().backward()
    assert tfc.LAUNCHES == before     # CPU tensors: the plain version
    _close(y, ref, what="y")
    for rx, rw in grads:
        _close(tx.grad, rx, what="dx")
        _close(tw.grad, rw, what="dw")
    # the moments epilogue: the sums of the (f32) conv output
    _, rs1, rs2 = jfc._conv_core(cfg, True, jnp.asarray(x), jnp.asarray(wt))
    _, s1, s2 = tfc._ConvCore.apply(torch.from_numpy(x),
                                    torch.from_numpy(wt), cfg, True)
    _close(s1, rs1, what="sum")
    _close(s2, rs2, what="sum_sq")


def test_lowering_crops_negative_pads_and_skips_empty_planes():
    """_input_grad's plane pads can be negative (a crop, as lax.pad
    does) and a 1x1 stride-2 conv's odd planes get no taps."""
    assert tfc._taps_1d(1, 2, 1, 0) is None
    assert tfc._taps_1d(3, 2, 0, 1) == ([1], 0)
    assert tfc._taps_1d(3, 2, 1, 1) == ([2, 0], 0)
    rng = np.random.default_rng(9)
    x = _rand(rng, (1, 2, 6, 7))
    w = _rand(rng, (3, 2, 3, 3))
    pads = ((-1, 2), (1, -2))
    plan = tfc._plan(x.shape, w.shape, (1, 1), pads)
    xp, wk = tfc._lower(torch.from_numpy(x), torch.from_numpy(w), plan)
    want = jax.lax.pad(jnp.asarray(x), 0.0, ((0, 0, 0), (0, 0, 0),
                                             (-1, 2, 0), (1, -2, 0)))
    _close(xp.permute(0, 3, 1, 2), want[:, :, :plan.ho + 2, :plan.wo + 2])
    y = tfc._conv_plain(xp, wk, plan)[0].permute(0, 3, 1, 2)
    _close(y, jfc._conv_ref(jnp.asarray(x), jnp.asarray(w), (1, 1), pads))


# ---------------------------------------------------------------------------
# the bf16 kernel's lowering: Ce padded to 8, the live-chunk walk
# ---------------------------------------------------------------------------


def _small_ints(rng, shape):
    """-2..2: every product and sum of a conv below is an integer far
    under 2^24, exact in f32 in any order."""
    return rng.integers(-2, 3, shape).astype(np.float32)


# (n, c, h, w, o, k, s, pad): the 12-channel space-to-depth stem, the
# 7x7 stride-2 stem on 3 channels, odd channel counts at stride 1 and 2,
# and a Ce already a multiple of 8
PAD_CASES = [(2, 12, 11, 10, 16, 4, 1, 0), (1, 3, 15, 14, 8, 7, 2, 3),
             (2, 5, 9, 10, 10, 3, 1, 1), (2, 5, 9, 10, 10, 3, 2, 1),
             (1, 16, 8, 9, 8, 1, 1, 0)]


@pytest.mark.parametrize("n,c,h,w,o,k,s,pad", PAD_CASES)
def test_bf16_lowering_pads_channels_to_eight(n, c, h, w, o, k, s, pad):
    """bf16 `_lower` pads Ce to a multiple of 8 with zero channels and
    zero weight rows; `_conv_plain` on the padded plane equals it on the
    unpadded f32 plane bit for bit (y cast once to bf16, the moments in
    f32), with operands whose sums are exact in any order."""
    rng = np.random.default_rng(c * 10 + k)
    x = torch.from_numpy(_small_ints(rng, (n, c, h, w)))
    wt = torch.from_numpy(_small_ints(rng, (o, c, k, k)))
    plan = tfc._plan(x.shape, wt.shape, (s, s), ((pad, pad), (pad, pad)))
    xp32, wk32 = tfc._lower(x, wt, plan)
    xp16, wk16 = tfc._lower(x.bfloat16(), wt.bfloat16(), plan)
    ce = xp32.shape[3]
    assert xp16.shape[3] % 8 == 0 and xp16.shape[3] - ce < 8
    assert wk16.shape == (wk32.shape[0], xp16.shape[3], o)
    assert torch.equal(xp16[..., :ce].float(), xp32)
    assert torch.equal(wk16[:, :ce].float(), wk32)
    assert not bool(xp16[..., ce:].any()) and not bool(wk16[:, ce:].any())
    y16, s16, q16 = tfc._conv_plain(xp16, wk16, plan, moments=True)
    y32, s32, q32 = tfc._conv_plain(xp32, wk32, plan, moments=True)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.bfloat16())
    assert torch.equal(s16, s32) and torch.equal(q16, q32)


# (k, s, c): 1x1 / 3x3 / 4x4 / 7x7 at strides 1 and 2; parity planes of
# 24 channels (chunks straddle planes), of 128 (whole chunks) and of 3 /
# 12 (the stems); each at odd and even extents
LIVE_CASES = [(1, 1, 64), (1, 2, 64), (3, 1, 24), (3, 2, 24), (3, 2, 128),
              (4, 1, 12), (4, 2, 20), (7, 1, 5), (7, 2, 3)]


@pytest.mark.parametrize("hw", [(9, 11), (10, 8)], ids=["odd", "even"])
@pytest.mark.parametrize("k,s,c", LIVE_CASES,
                         ids=[f"k{k}s{s}c{c}" for k, s, c in LIVE_CASES])
def test_live_chunks_cover_every_nonzero_row(k, s, c, hw):
    """The chunks the bf16 kernel walks (`_live_chunks`, derived from the
    plan alone) hold every row of the lowered wk that can be nonzero and
    no chunk that is all zero, in order."""
    rng = np.random.default_rng(k * 100 + s * 10 + c)
    x = torch.from_numpy(rng.standard_normal((1, c) + hw).astype(
        np.float32)).bfloat16()
    wt = torch.from_numpy(rng.standard_normal((8, c, k, k)).astype(
        np.float32) + 3.0).bfloat16()       # no weight is 0
    pad = k // 2
    plan = tfc._plan(x.shape, wt.shape, (s, s), ((pad, pad), (pad, pad)))
    _, wk = tfc._lower(x, wt, plan)
    ce = wk.shape[1]
    nonzero = wk.reshape(-1, 8).ne(0).any(1).tolist()
    assert tfc._live_rows(plan, ce) == nonzero
    step = tfc._CHUNK_K
    nk = -(-len(nonzero) // step)
    live = list(tfc._live_chunks(plan, ce))
    assert live == sorted(live)
    for i in range(nk):
        has = any(nonzero[i * step:(i + 1) * step])
        assert has == (i in live), (i, has, live)


@pytest.mark.parametrize("k,s,c", [(3, 2, 24), (3, 2, 128), (7, 2, 3),
                                   (4, 2, 20), (1, 2, 8)])
def test_live_chunks_sum_to_the_full_conv(k, s, c):
    """The conv summed over the live chunks alone (each chunk's rows of
    wk, the others zeroed) equals the conv over the whole lowered K, bit
    for bit with exact operands: the skipped chunks add nothing."""
    rng = np.random.default_rng(k + s + c)
    x = torch.from_numpy(_small_ints(rng, (2, c, 9, 10)))
    wt = torch.from_numpy(_small_ints(rng, (8, c, k, k)))
    pad = k // 2
    plan = tfc._plan(x.shape, wt.shape, (s, s), ((pad, pad), (pad, pad)))
    xp, wk = tfc._lower(x.bfloat16(), wt.bfloat16(), plan)
    full = tfc._conv_plain(xp.float(), wk.float(), plan)[0]
    flat = wk.float().reshape(-1, wk.shape[2])
    step = tfc._CHUNK_K
    total = torch.zeros_like(full)
    for i in tfc._live_chunks(plan, wk.shape[1]):
        part = torch.zeros_like(flat)
        part[i * step:(i + 1) * step] = flat[i * step:(i + 1) * step]
        total += tfc._conv_plain(xp.float(), part.reshape(wk.shape), plan)[0]
    assert torch.equal(total, full)


def test_live_chunks_raise_past_the_kernels_list():
    """The bf16 kernel takes at most `_MAX_LIVE` chunks (K up to 32768):
    a longer K raises instead of being walked some other way."""
    c = tfc._MAX_LIVE * tfc._CHUNK_K
    for ce, ok in ((c, True), (c + 8, False)):
        plan = tfc._plan((1, ce, 4, 4), (8, ce, 1, 1), (1, 1),
                         ((0, 0), (0, 0)))
        if ok:
            assert len(tfc._live_chunks(plan, ce)) == tfc._MAX_LIVE
        else:
            with pytest.raises(ValueError, match="live K chunks"):
                tfc._live_chunks(plan, ce)


# ---------------------------------------------------------------------------
# fused_conv2d_bn_act against the reference op
# ---------------------------------------------------------------------------

# tests/test_fused_conv.py's fused cases: (k, s, p, act, is_test, res)
FUSED_CASES = [
    (1, 1, 0, "relu", False, False),
    (3, 1, 1, "relu", False, True),
    (3, 2, 1, "relu", False, False),
    (1, 1, 0, "identity", False, False),
    (3, 1, 1, "relu", True, True),
    (1, 2, 0, "relu", True, False),
    (7, 2, 3, "relu", True, False),
]
FUSED_IDS = ["train-1x1", "train-3x3-res", "train-3x3-s2", "train-ident",
             "eval-3x3-res", "eval-1x1-s2", "eval-7x7-s2"]


def _fused_inputs(k, s, p, with_res, seed=2):
    rng = np.random.default_rng(seed)
    n, c, h, wd, o = 2, 8, 9, 11, 16
    if k == 7:
        c, h, wd, o = 3, 15, 14, 8
    ho = (h + 2 * p - k) // s + 1
    wo = (wd + 2 * p - k) // s + 1
    return dict(
        x=_rand(rng, (n, c, h, wd)), w=_rand(rng, (o, c, k, k), 0.1),
        g=rng.uniform(0.5, 1.5, o).astype(np.float32),
        b=_rand(rng, (o,), 0.1), mean=_rand(rng, (o,), 0.1),
        var=rng.uniform(0.5, 1.5, o).astype(np.float32),
        res=_rand(rng, (n, o, ho, wo)) if with_res else None)


def _check_fused_case(k, s, p, act, is_test, with_res):
    """y, the new running stats and every gradient of the port's
    fused_conv2d_bn_act against the reference's default path."""
    d = _fused_inputs(k, s, p, with_res)
    kw = dict(stride=s, padding=p, momentum=0.9, epsilon=1e-5, act=act,
              is_test=is_test)
    names = ["x", "w", "g", "b"] + (["res"] if with_res else [])

    def ref_loss(*a):
        y, stats = jfc.fused_conv2d_bn_act(
            a[0], a[1], a[2], a[3], jnp.asarray(d["mean"]),
            jnp.asarray(d["var"]), residual=a[4] if with_res else None, **kw)
        return jnp.sum(jnp.sin(y)), (y, stats)

    jargs = [jnp.asarray(d[k_]) for k_ in names]
    (_, (ry, (rm, rv))), rgrads = jax.value_and_grad(
        ref_loss, tuple(range(len(names))), has_aux=True)(*jargs)
    targs = [_leaf(d[k_]) for k_ in names]
    ty, (tm, tv) = tfc.fused_conv2d_bn_act(
        targs[0], targs[1], targs[2], targs[3], torch.from_numpy(d["mean"]),
        torch.from_numpy(d["var"]),
        residual=targs[4] if with_res else None, **kw)
    ty.sin().sum().backward()
    _close(ty, ry, what="y")
    _close(tm, rm, what="running mean")
    _close(tv, rv, what="running var")
    for name, t, r in zip(names, targs, rgrads):
        _close(t.grad, r, what=f"d{name}")


@pytest.mark.parametrize("k,s,p,act,is_test,with_res", FUSED_CASES,
                         ids=FUSED_IDS)
def test_fused_conv2d_bn_act_matches_reference(k, s, p, act, is_test,
                                               with_res):
    _check_fused_case(k, s, p, act, is_test, with_res)


@pytest.mark.parametrize("k,s,p,act,is_test,with_res", FUSED_CASES,
                         ids=FUSED_IDS)
def test_fused_conv2d_bn_act_flag_off_composes(k, s, p, act, is_test,
                                               with_res, monkeypatch):
    """FLAGS_use_pallas_conv off: the fused op never reaches the fused
    conv's autograd Functions (B10 and its plain version) and composes
    torch's conv with fused_bn_act, which still matches the reference."""
    def unreachable(*a, **k_):
        raise AssertionError("flag off reached the fused conv")

    monkeypatch.setattr(tfc._ConvCore, "apply", unreachable)
    monkeypatch.setattr(tfc._ConvAffine, "apply", unreachable)
    tflags.set_flags({"FLAGS_use_pallas_conv": False})
    try:
        _check_fused_case(k, s, p, act, is_test, with_res)
    finally:
        tflags.set_flags({"FLAGS_use_pallas_conv": True})


def test_fused_conv2d_bn_act_bf16():
    """amp's layout: bf16 x / w / residual, f32 BN parameters; training
    (moments) and eval (affine epilogue). Tolerances: module
    docstring."""
    d = _fused_inputs(3, 1, 1, True, seed=3)
    bf = jnp.bfloat16
    kw = dict(stride=1, padding=1, momentum=0.9, epsilon=1e-5, act="relu")
    for is_test in (False, True):
        ry, (rm, rv) = jfc.fused_conv2d_bn_act(
            jnp.asarray(d["x"], bf), jnp.asarray(d["w"], bf),
            jnp.asarray(d["g"]), jnp.asarray(d["b"]), jnp.asarray(d["mean"]),
            jnp.asarray(d["var"]), residual=jnp.asarray(d["res"], bf),
            is_test=is_test, **kw)
        ty, (tm, tv) = tfc.fused_conv2d_bn_act(
            torch.from_numpy(d["x"]).bfloat16(),
            torch.from_numpy(d["w"]).bfloat16(), torch.from_numpy(d["g"]),
            torch.from_numpy(d["b"]), torch.from_numpy(d["mean"]),
            torch.from_numpy(d["var"]),
            residual=torch.from_numpy(d["res"]).bfloat16(),
            is_test=is_test, **kw)
        assert ty.dtype == torch.bfloat16 and ry.dtype == jnp.bfloat16
        assert tm.dtype == torch.float32 and rm.dtype == jnp.float32
        got = ty.float().numpy()
        want = np.asarray(ry, np.float32)
        np.testing.assert_allclose(
            got, want, rtol=2 ** -7, atol=2 ** -8 * np.abs(want).max())
        _close(tm, rm, rtol=2e-4, what="running mean")
        _close(tv, rv, rtol=2e-4, what="running var")


def test_unsupported_conv_composes():
    """A grouped conv is outside the kernel's space: the fused op
    composes torch's conv + fused_bn_act, as the reference composes lax
    + fused_bn_act."""
    rng = np.random.default_rng(4)
    x, w = _rand(rng, (1, 8, 7, 7)), _rand(rng, (16, 4, 3, 3), 0.1)
    g = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    b, mean = _rand(rng, (16,), 0.1), _rand(rng, (16,), 0.1)
    var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    before = tfc.LAUNCHES
    for is_test in (True, False):
        ry, _ = jfc.fused_conv2d_bn_act(
            *(jnp.asarray(a) for a in (x, w, g, b, mean, var)), stride=1,
            padding=1, groups=2, act="relu", is_test=is_test)
        ty, _ = tfc.fused_conv2d_bn_act(
            *(torch.from_numpy(a) for a in (x, w, g, b, mean, var)),
            stride=1, padding=1, groups=2, act="relu", is_test=is_test)
        _close(ty, ry)
    assert tfc.LAUNCHES == before


# ---------------------------------------------------------------------------
# batch norm, fused_bn_act, pooling
# ---------------------------------------------------------------------------


def _bn_inputs(seed=5, res=False):
    rng = np.random.default_rng(seed)
    c = 6
    return dict(x=_rand(rng, (3, c, 5, 4), 2.0) + 0.5,
                g=rng.uniform(0.5, 1.5, c).astype(np.float32),
                b=_rand(rng, (c,), 0.1), mean=_rand(rng, (c,), 0.1),
                var=rng.uniform(0.5, 1.5, c).astype(np.float32),
                res=_rand(rng, (3, c, 5, 4)) if res else None)


@pytest.mark.parametrize("op,act,is_test,res", [
    ("batch_norm", None, False, False), ("batch_norm", None, True, False),
    ("fused_bn_act", "relu", False, True),
    ("fused_bn_act", "identity", False, False),
    ("fused_bn_act", "relu", True, True),
], ids=["bn-train", "bn-eval", "fused-relu-res", "fused-ident",
        "fused-eval"])
def test_batch_norm_ops_match_reference(op, act, is_test, res):
    d = _bn_inputs(res=res)
    names = ["x", "g", "b"] + (["res"] if res else [])
    extra = {} if op == "batch_norm" else {"act": act}

    def ref_loss(*a):
        args = (a[0], a[1], a[2], jnp.asarray(d["mean"]),
                jnp.asarray(d["var"]))
        if op == "fused_bn_act":
            args += (a[3] if res else None,)
        y, stats = getattr(jnn_ops, op)(*args, momentum=0.9, epsilon=1e-5,
                                        is_test=is_test, **extra)
        return jnp.sum(jnp.sin(y)), (y, stats)

    (_, (ry, (rm, rv))), rgrads = jax.value_and_grad(
        ref_loss, tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(d[k]) for k in names))
    targs = [_leaf(d[k]) for k in names]
    args = (targs[0], targs[1], targs[2], torch.from_numpy(d["mean"]),
            torch.from_numpy(d["var"]))
    if op == "fused_bn_act":
        args += (targs[3] if res else None,)
    ty, (tm, tv) = getattr(tnn_ops, op)(*args, momentum=0.9, epsilon=1e-5,
                                        is_test=is_test, **extra)
    ty.sin().sum().backward()
    _close(ty, ry, what="y")
    _close(tm, rm, what="running mean")
    _close(tv, rv, what="running var")
    for name, t, r in zip(names, targs, rgrads):
        _close(t.grad, r, what=f"d{name}")


def test_running_stats_follow_paddle_convention():
    """momentum weights the OLD stat, and the variance is the biased one
    (torch's batch norm would write the unbiased)."""
    d = _bn_inputs()
    bn = tnn.BatchNorm2D(6, momentum=0.9)
    with torch.no_grad():
        bn._mean.copy_(torch.from_numpy(d["mean"]))
        bn._variance.copy_(torch.from_numpy(d["var"]))
    bn.train()
    bn(torch.from_numpy(d["x"]))
    x = d["x"].astype(np.float64)
    want_m = 0.9 * d["mean"] + 0.1 * x.mean(axis=(0, 2, 3))
    want_v = 0.9 * d["var"] + 0.1 * x.var(axis=(0, 2, 3))
    _close(bn._mean, want_m)
    _close(bn._variance, want_v)


@pytest.mark.parametrize("kind", ["max3s2p1", "max_ceil", "adaptive1",
                                  "adaptive_uneven", "avg_pad"])
def test_pooling_matches_reference(kind):
    rng = np.random.default_rng(6)
    x = _rand(rng, (2, 3, 9, 7))
    kw = {"max3s2p1": dict(ksize=3, stride=2, padding=1),
          "max_ceil": dict(ksize=2, stride=2, padding=0, ceil_mode=True),
          "adaptive1": dict(ksize=(1, 1), adaptive=True,
                            pooling_type="avg"),
          "adaptive_uneven": dict(ksize=(2, 3), adaptive=True,
                                  pooling_type="avg"),
          "avg_pad": dict(ksize=3, stride=2, padding=1,
                          pooling_type="avg")}[kind]

    def ref(a):
        y = jnn_ops.pool2d(a, **kw)
        return jnp.sum(jnp.sin(y)), y

    (_, ry), rg = jax.value_and_grad(ref, has_aux=True)(jnp.asarray(x))
    tx = _leaf(x)
    ty = tnn_ops.pool2d(tx, **kw)
    ty.sin().sum().backward()
    _close(ty, ry, what="y")
    _close(tx.grad, rg, what="dx")


# ---------------------------------------------------------------------------
# Momentum through both engines
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["heavy-ball", "nesterov"])
def test_momentum_matches_reference_engine(nesterov):
    rng = np.random.RandomState(7)
    vals = {"fc.weight": rng.randn(4, 3).astype(np.float32),
            "fc.bias": rng.randn(3).astype(np.float32)}
    kw = dict(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
              weight_decay=1e-2)
    jm = _JNet()
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    jcrit = paddle.nn.CrossEntropyLoss()
    jeng = jengine.Engine(jm, paddle.optimizer.Momentum(
        parameters=jm.parameters(), **kw), lambda lg, y: jcrit(lg, y))
    tm = _TNet()
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in vals.items()})
    tcrit = tnn.CrossEntropyLoss()
    teng = tengine.Engine(tm, topt.Momentum(parameters=tm.parameters(),
                                            **kw),
                          lambda lg, y: tcrit(lg, y), device="cpu")
    for _ in range(3):
        x = rng.randn(8, 4).astype(np.float32)
        y = rng.randint(0, 3, (8,)).astype(np.int64)
        jl = float(np.asarray(jeng.train_batch(x, y)._value))
        tl = float(teng.train_batch(x, y))
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for k in vals:
        np.testing.assert_allclose(
            teng.state.params[k].detach().numpy(),
            np.asarray(jeng.state.params[k]), rtol=1e-6, atol=1e-7,
            err_msg=k)
        np.testing.assert_allclose(
            teng.state.opt_state[k]["velocity"].numpy(),
            np.asarray(jeng.state.opt_state[k]["velocity"]), rtol=1e-6,
            atol=1e-7, err_msg=f"{k}.velocity")
    # a fresh port engine resumes from the reference's parameters and
    # velocities (weights.from_paddle_tpu_opt_state) and steps alike
    tm2 = _TNet()
    weights.from_paddle_tpu_values(
        {k: np.asarray(v) for k, v in jeng.state.params.items()}, tm2,
        device="cpu")
    teng2 = tengine.Engine(tm2, topt.Momentum(parameters=tm2.parameters(),
                                              **kw),
                           lambda lg, y: tcrit(lg, y), device="cpu")
    weights.from_paddle_tpu_opt_state(jeng.state.opt_state, teng2)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randint(0, 3, (8,)).astype(np.int64)
    np.testing.assert_allclose(float(teng2.train_batch(x, y)),
                               float(np.asarray(jeng.train_batch(x, y)._value)),
                               rtol=1e-6)
    for k in vals:
        np.testing.assert_allclose(
            teng2.state.params[k].detach().numpy(),
            np.asarray(jeng.state.params[k]), rtol=1e-6, atol=1e-7,
            err_msg=k)
