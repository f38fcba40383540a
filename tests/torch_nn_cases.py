"""The nn surface as a table of calls: every public function of
``nn.functional`` and every layer class of ``nn``, each with numpy
inputs drawn from a seeded generator and a call written against paddle's
API, so the same case runs in both packages (`tests/test_torch_nn_*`:
the port against paddle_tpu on the CPU) and in the port on two devices
(chip_smoke.py's sweep: CUDA against the CPU).

This module imports numpy only. Shapes stay within what the CUDA
kernels take (head_dim 32 / 64 / 128 for flash attention, a hidden size
the fused LM-head loss knows), since the sweep runs every case there.
A functional case calls ``F.<name>`` on the tensors built from
``make(rng)``; a layer case builds
``ctor(nn)`` and calls it on them. ``grad`` says whether the call is
differentiated (every float input, and every float parameter of a
layer, against a fixed cotangent); ``red`` marks a case that sums 64 or
more terms (its absolute tolerance is 1e-5 instead of 1e-6); ``train``
runs a layer in training mode. Random ops (dropout and the like) are
not here: they cannot repeat the reference's draws and are tested by
their properties.
"""

from __future__ import annotations

import numpy as np

RTOL, ATOL, ATOL_RED = 1e-5, 1e-6, 1e-5


class Case:
    def __init__(self, fn, make, call, cid=None, grad=True, red=False,
                 train=True):
        self.fn = fn                # the public name it covers
        self.id = cid or fn
        self.make = make
        self.call = call
        self.grad = grad
        self.red = red
        self.train = train

    def inputs(self, seed=0):
        return self.make(np.random.default_rng(seed))

    @property
    def atol(self):
        return ATOL_RED if self.red else ATOL


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _u(rng, *shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _i(rng, hi, *shape, lo=0):
    return rng.integers(lo, hi, shape).astype(np.int64)


def _logp(rng, *shape):
    x = _n(rng, *shape)
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _x(rng):
    return (_n(rng, 4, 6, scale=2.0),)


def _img(rng):
    return (_n(rng, 2, 3, 4, 4, scale=2.0),)


F_CASES = []


def _f(fn, make, call, **kw):
    F_CASES.append(Case(fn, make, call, **kw))


# -- activations -----------------------------------------------------------
for _name, _kw in [
        ("relu", {}), ("relu6", {}), ("gelu", {}), ("sigmoid", {}),
        ("log_sigmoid", {}), ("tanh", {}), ("silu", {}), ("swish", {}),
        ("mish", {}), ("leaky_relu", {"negative_slope": 0.1}),
        ("elu", {"alpha": 0.7}), ("celu", {"alpha": 0.8}), ("selu", {}),
        ("hardtanh", {"min": -0.5, "max": 0.7}), ("hardsigmoid", {}),
        ("hardswish", {}), ("hardshrink", {"threshold": 0.4}),
        ("softshrink", {"threshold": 0.3}),
        ("softplus", {"beta": 2.0, "threshold": 3.0}), ("softsign", {}),
        ("tanhshrink", {}), ("thresholded_relu", {"threshold": 0.5})]:
    _f(_name, _x, (lambda n, kw: lambda F, x: getattr(F, n)(x, **kw))(
        _name, _kw))
_f("relu6", lambda r: (_n(r, 4, 6, scale=5.0),), lambda F, x: F.relu6(x),
   cid="relu6-wide")
_f("gelu", _x, lambda F, x: F.gelu(x, approximate=True), cid="gelu-tanh")
_f("prelu", lambda r: (_n(r, 2, 3, 4, 4), _u(r, 1, 3, 1, 1)),
   lambda F, x, w: F.prelu(x, w))
_f("softmax", _x, lambda F, x: F.softmax(x, axis=0))
_f("log_softmax", _x, lambda F, x: F.log_softmax(x, axis=1))
_f("maxout", lambda r: (_n(r, 2, 6, 3, 3),), lambda F, x: F.maxout(x, 2))
_f("glu", _x, lambda F, x: F.glu(x, axis=-1))

# -- linear, conv ----------------------------------------------------------
_f("linear", lambda r: (_n(r, 3, 5), _n(r, 5, 4), _n(r, 4)),
   lambda F, x, w, b: F.linear(x, w, b))
# the port's functional matmul (the reference's is paddle.matmul)
_f("matmul", lambda r: (_n(r, 2, 3, 5), _n(r, 2, 4, 5)),
   lambda F, x, y: F.matmul(x, y, transpose_y=True))
_f("conv1d", lambda r: (_n(r, 2, 4, 9), _n(r, 6, 4, 3), _n(r, 6)),
   lambda F, x, w, b: F.conv1d(x, w, b, stride=2, padding=1), red=True)
_f("conv2d", lambda r: (_n(r, 2, 4, 7, 7), _n(r, 6, 2, 3, 3), _n(r, 6)),
   lambda F, x, w, b: F.conv2d(x, w, b, padding=[1, 2], groups=2),
   red=True)
_f("conv2d", lambda r: (_n(r, 2, 7, 7, 4), _n(r, 6, 4, 3, 3), _n(r, 6)),
   lambda F, x, w, b: F.conv2d(x, w, b, stride=2, padding=1,
                               data_format="NHWC"), cid="conv2d-nhwc",
   red=True)
_f("conv3d", lambda r: (_n(r, 2, 3, 5, 6, 5), _n(r, 4, 3, 2, 3, 2),
                        _n(r, 4)),
   lambda F, x, w, b: F.conv3d(x, w, b, stride=(1, 2, 1), padding=1),
   red=True)
_f("conv1d_transpose", lambda r: (_n(r, 2, 4, 7), _n(r, 4, 3, 3), _n(r, 3)),
   lambda F, x, w, b: F.conv1d_transpose(x, w, b, stride=2, padding=1,
                                         output_padding=1), red=True)
_f("conv2d_transpose", lambda r: (_n(r, 2, 4, 5, 5), _n(r, 4, 3, 3, 3),
                                  _n(r, 6)),
   lambda F, x, w, b: F.conv2d_transpose(x, w, b, stride=2, padding=1,
                                         output_padding=1, groups=2),
   red=True)
_f("conv2d_transpose", lambda r: (_n(r, 2, 4, 5, 6), _n(r, 4, 3, 3, 2)),
   lambda F, x, w: F.conv2d_transpose(x, w, stride=(2, 1),
                                      padding=[1, 0, 2, 1], dilation=2),
   cid="conv2d_transpose-asym", red=True)
_f("conv3d_transpose", lambda r: (_n(r, 1, 4, 3, 4, 3),
                                  _n(r, 4, 2, 2, 2, 2), _n(r, 2)),
   lambda F, x, w, b: F.conv3d_transpose(x, w, b, stride=2, padding=1),
   red=True)

# -- pooling ---------------------------------------------------------------
_f("max_pool1d", lambda r: (_n(r, 2, 3, 11),),
   lambda F, x: F.max_pool1d(x, 3, 2, 1))
_f("max_pool1d", lambda r: (_n(r, 2, 3, 11),),
   lambda F, x: F.max_pool1d(x, 3, 2, 1, return_mask=True),
   cid="max_pool1d-mask")
_f("max_pool2d", lambda r: (_n(r, 2, 3, 9, 9),),
   lambda F, x: F.max_pool2d(x, 3, 2, 1, ceil_mode=True))
_f("max_pool2d", lambda r: (_n(r, 2, 3, 9, 8),),
   lambda F, x: F.max_pool2d(x, 3, 2, 1, return_mask=True),
   cid="max_pool2d-mask")
_f("max_pool3d", lambda r: (_n(r, 2, 2, 6, 7, 5),),
   lambda F, x: F.max_pool3d(x, 2, 2))
_f("max_pool3d", lambda r: (_n(r, 2, 2, 6, 7, 5),),
   lambda F, x: F.max_pool3d(x, 3, 2, 1, return_mask=True),
   cid="max_pool3d-mask")
_f("avg_pool1d", lambda r: (_n(r, 2, 3, 11),),
   lambda F, x: F.avg_pool1d(x, 3, 2, 1))
_f("avg_pool2d", lambda r: (_n(r, 2, 3, 9, 9),),
   lambda F, x: F.avg_pool2d(x, 3, 2, 1, exclusive=False))
_f("avg_pool2d", lambda r: (_n(r, 2, 3, 9, 9),),
   lambda F, x: F.avg_pool2d(x, 3, 2, 1, ceil_mode=True),
   cid="avg_pool2d-exclusive")
_f("avg_pool3d", lambda r: (_n(r, 2, 2, 6, 7, 5),),
   lambda F, x: F.avg_pool3d(x, 2, 2, 1))
_f("adaptive_avg_pool1d", lambda r: (_n(r, 2, 3, 10),),
   lambda F, x: F.adaptive_avg_pool1d(x, 4))
_f("adaptive_avg_pool2d", lambda r: (_n(r, 2, 3, 7, 9),),
   lambda F, x: F.adaptive_avg_pool2d(x, [3, 4]))
_f("adaptive_avg_pool3d", lambda r: (_n(r, 2, 2, 5, 6, 7),),
   lambda F, x: F.adaptive_avg_pool3d(x, [2, 3, 3]))
_f("adaptive_max_pool1d", lambda r: (_n(r, 2, 3, 10),),
   lambda F, x: F.adaptive_max_pool1d(x, 4, return_mask=True))
_f("adaptive_max_pool2d", lambda r: (_n(r, 2, 3, 7, 9),),
   lambda F, x: F.adaptive_max_pool2d(x, [3, 4], return_mask=True))
_f("adaptive_max_pool2d", lambda r: (_n(r, 2, 3, 8, 8),),
   lambda F, x: F.adaptive_max_pool2d(x, 4), cid="adaptive_max_pool2d-even")
_f("adaptive_max_pool3d", lambda r: (_n(r, 2, 2, 5, 6, 7),),
   lambda F, x: F.adaptive_max_pool3d(x, [2, 3, 3], return_mask=True))

# -- normalisation ---------------------------------------------------------


def _bn_inputs(r, shape, c):
    return (_n(r, *shape, scale=2.0), _n(r, c), _u(r, c, lo=0.5, hi=2.0),
            _n(r, c), _n(r, c))


_f("layer_norm", lambda r: (_n(r, 3, 4, 6, scale=2.0), _n(r, 24), _n(r, 24)),
   lambda F, x, w, b: F.layer_norm(x, [4, 6], w, b))
_f("batch_norm", lambda r: _bn_inputs(r, (4, 3, 5, 5), 3),
   lambda F, x, m, v, w, b: F.batch_norm(x, m, v, w, b, training=True),
   red=True)
_f("batch_norm", lambda r: _bn_inputs(r, (4, 5, 5, 3), 3),
   lambda F, x, m, v, w, b: F.batch_norm(x, m, v, w, b, training=True,
                                         data_format="NHWC"),
   cid="batch_norm-nhwc", red=True)
_f("batch_norm", lambda r: _bn_inputs(r, (4, 3, 5, 5), 3),
   lambda F, x, m, v, w, b: F.batch_norm(x, m, v, w, b, training=False),
   cid="batch_norm-eval")
_f("fused_bn_act", lambda r: _bn_inputs(r, (4, 3, 5, 5), 3),
   lambda F, x, m, v, w, b: F.fused_bn_act(x, m, v, w, b, training=True),
   red=True)
_f("fused_conv2d_bn_act",
   lambda r: (_n(r, 2, 4, 6, 6), _n(r, 5, 4, 3, 3)) + _bn_inputs(
       r, (1,), 5)[1:],
   lambda F, x, wc, m, v, w, b: F.fused_conv2d_bn_act(
       x, wc, m, v, w, b, padding=1, training=True), red=True)
_f("instance_norm", lambda r: (_n(r, 2, 3, 5, 5, scale=2.0), _n(r, 3),
                               _n(r, 3)),
   lambda F, x, w, b: F.instance_norm(x, weight=w, bias=b))
_f("group_norm", lambda r: (_n(r, 2, 6, 4, 4, scale=2.0), _n(r, 6),
                            _n(r, 6)),
   lambda F, x, w, b: F.group_norm(x, 3, weight=w, bias=b))
_f("normalize", _x, lambda F, x: F.normalize(x, axis=1))
_f("normalize", _x, lambda F, x: F.normalize(x, p=3, axis=0),
   cid="normalize-p3")
_f("local_response_norm", lambda r: (_n(r, 2, 6, 4, 4),),
   lambda F, x: F.local_response_norm(x, 3, alpha=0.1))

# -- dropout in eval, embedding --------------------------------------------
_f("dropout", _x, lambda F, x: F.dropout(x, 0.3, training=False,
                                         mode="downscale_in_infer"))
_f("dropout2d", _img, lambda F, x: F.dropout2d(x, 0.3, training=False))
_f("dropout3d", lambda r: (_n(r, 2, 3, 2, 3, 3),),
   lambda F, x: F.dropout3d(x, 0.3, training=False))
_f("alpha_dropout", _x, lambda F, x: F.alpha_dropout(x, 0.3,
                                                     training=False))
_f("embedding", lambda r: (_i(r, 10, 3, 5), _n(r, 10, 4)),
   lambda F, i, w: F.embedding(i, w, padding_idx=2))
_f("one_hot", lambda r: (_i(r, 7, 3, 5),), lambda F, i: F.one_hot(i, 7),
   grad=False)

# -- losses ----------------------------------------------------------------


def _labels_with_ignored(r):
    lbl = _i(r, 5, 6)
    lbl[2] = -100
    return lbl


_f("cross_entropy", lambda r: (_n(r, 6, 5), _labels_with_ignored(r),
                               _u(r, 5, lo=0.5, hi=2.0)),
   lambda F, x, y, w: F.cross_entropy(x, y, weight=w))
_f("cross_entropy", lambda r: (_n(r, 6, 5), _logp(r, 6, 5)),
   lambda F, x, y: F.cross_entropy(x, F.softmax(y), soft_label=True),
   cid="cross_entropy-soft")
_f("cross_entropy", lambda r: (_n(r, 2, 5, 3), _i(r, 5, 2, 1, 3)),
   lambda F, x, y: F.cross_entropy(x, y, axis=1, reduction="sum"),
   cid="cross_entropy-axis1")
_f("cross_entropy", lambda r: (_u(r, 6, 5, lo=0.05, hi=1.0), _i(r, 5, 6)),
   lambda F, x, y: F.cross_entropy(x, y, use_softmax=False,
                                   reduction="none"),
   cid="cross_entropy-probs")
_f("fused_linear_cross_entropy", lambda r: (_n(r, 6, 64), _n(r, 11, 64),
                                            _labels_with_ignored(r)),
   lambda F, h, w, y: F.fused_linear_cross_entropy(h, w, y), red=True)
_f("softmax_with_cross_entropy", lambda r: (_n(r, 6, 5), _i(r, 5, 6, 1)),
   lambda F, x, y: F.softmax_with_cross_entropy(x, y, return_softmax=True))
_f("binary_cross_entropy", lambda r: (_u(r, 4, 5, lo=0.02, hi=0.98),
                                      _i(r, 2, 4, 5).astype(np.float32),
                                      _u(r, 4, 5)),
   lambda F, x, y, w: F.binary_cross_entropy(x, y, w))
_f("binary_cross_entropy_with_logits",
   lambda r: (_n(r, 4, 5), _i(r, 2, 4, 5).astype(np.float32), _u(r, 5),
              _u(r, 5, lo=0.5, hi=3.0)),
   lambda F, x, y, w, pw: F.binary_cross_entropy_with_logits(
       x, y, w, pos_weight=pw))
_f("mse_loss", lambda r: (_n(r, 4, 5), _n(r, 4, 5)),
   lambda F, x, y: F.mse_loss(x, y))
_f("square_error_cost", lambda r: (_n(r, 4, 5), _n(r, 4, 5)),
   lambda F, x, y: F.square_error_cost(x, y))
_f("l1_loss", lambda r: (_n(r, 4, 5), _n(r, 4, 5)),
   lambda F, x, y: F.l1_loss(x, y, reduction="sum"))
_f("smooth_l1_loss", lambda r: (_n(r, 4, 5), _n(r, 4, 5)),
   lambda F, x, y: F.smooth_l1_loss(x, y, delta=0.5))


def _ctc(r):
    return (_logp(r, 12, 3, 5), _i(r, 5, 3, 4, lo=1),
            np.array([12, 10, 9], np.int64), np.array([4, 3, 2], np.int64))


_f("ctc_loss", _ctc, lambda F, lp, y, il, ll: F.ctc_loss(lp, y, il, ll))
_f("ctc_loss", _ctc, lambda F, lp, y, il, ll: F.ctc_loss(
    lp, y, il, ll, reduction="none", norm_by_times=True),
   cid="ctc_loss-norm_by_times")
_f("npair_loss", lambda r: (_n(r, 6, 4), _n(r, 6, 4), _i(r, 3, 6)),
   lambda F, a, p, y: F.npair_loss(a, p, y))
_f("nll_loss", lambda r: (_logp(r, 6, 5), _labels_with_ignored(r),
                          _u(r, 5, lo=0.5, hi=2.0)),
   lambda F, x, y, w: F.nll_loss(x, y, weight=w))
_f("kl_div", lambda r: (_logp(r, 4, 6), np.exp(_logp(r, 4, 6))),
   lambda F, x, y: F.kl_div(x, y, reduction="batchmean"))
_f("margin_ranking_loss",
   lambda r: (_n(r, 6), _n(r, 6), (2 * _i(r, 2, 6) - 1).astype(np.float32)),
   lambda F, x, o, y: F.margin_ranking_loss(x, o, y, margin=0.1))
_f("sigmoid_focal_loss",
   lambda r: (_n(r, 6, 3), _i(r, 2, 6, 3).astype(np.float32),
              np.array([4.0], np.float32)),
   lambda F, x, y, n: F.sigmoid_focal_loss(x, y, normalizer=n))
_f("hsigmoid_loss", lambda r: (_n(r, 5, 8), _i(r, 6, 5), _n(r, 5, 8),
                               _n(r, 5, 1)),
   lambda F, x, y, w, b: F.hsigmoid_loss(x, y, 6, w, b))
_f("cosine_similarity", lambda r: (_n(r, 4, 6), _n(r, 4, 6)),
   lambda F, a, b: F.cosine_similarity(a, b, axis=1))
_f("pairwise_distance", lambda r: (_n(r, 4, 6), _n(r, 4, 6)),
   lambda F, a, b: F.pairwise_distance(a, b, p=3.0))

# -- shape, resize, sampling, attention ------------------------------------
for _mode in ("constant", "reflect", "replicate", "circular"):
    _f("pad", lambda r: (_n(r, 2, 3, 4, 5),),
       (lambda m: lambda F, x: F.pad(x, [1, 2, 0, 1], mode=m, value=0.5))(
           _mode), cid=f"pad-{_mode}")
_f("interpolate", lambda r: (_n(r, 2, 3, 5, 7),),
   lambda F, x: F.interpolate(x, size=[8, 4], mode="bilinear"))
_f("interpolate", lambda r: (_n(r, 2, 3, 5, 7),),
   lambda F, x: F.interpolate(x, scale_factor=2, mode="nearest"),
   cid="interpolate-nearest")
_f("interpolate", lambda r: (_n(r, 2, 3, 6, 5),),
   lambda F, x: F.interpolate(x, size=[9, 3], mode="bicubic"),
   cid="interpolate-bicubic")
_f("interpolate", lambda r: (_n(r, 1, 2, 3, 4, 5),),
   lambda F, x: F.interpolate(x, size=[5, 3, 7], mode="trilinear",
                              data_format="NCDHW"),
   cid="interpolate-trilinear")
_f("upsample", lambda r: (_n(r, 2, 3, 5, 7),),
   lambda F, x: F.upsample(x, size=[7, 3], mode="nearest"))
_f("pixel_shuffle", lambda r: (_n(r, 2, 8, 3, 3),),
   lambda F, x: F.pixel_shuffle(x, 2))
_f("unfold", lambda r: (_n(r, 2, 3, 6, 6),),
   lambda F, x: F.unfold(x, [2, 3], strides=2, paddings=1))
_f("temporal_shift", lambda r: (_n(r, 4, 8, 3, 3),),
   lambda F, x: F.temporal_shift(x, 2))
_f("grid_sample", lambda r: (_n(r, 2, 3, 5, 6), _u(r, 2, 4, 4, 2, lo=-1.1,
                                                   hi=1.1)),
   lambda F, x, g: F.grid_sample(x, g))
_f("grid_sample", lambda r: (_n(r, 2, 3, 5, 6), _u(r, 2, 4, 4, 2, lo=-1.3,
                                                   hi=1.3)),
   lambda F, x, g: F.grid_sample(x, g, padding_mode="reflection",
                                 align_corners=False),
   cid="grid_sample-reflection")
_f("grid_sample", lambda r: (_n(r, 2, 3, 5, 6), _u(r, 2, 4, 4, 2, lo=-1.1,
                                                   hi=1.1)),
   lambda F, x, g: F.grid_sample(x, g, mode="nearest",
                                 padding_mode="border"),
   cid="grid_sample-nearest", grad=False)
_f("affine_grid", lambda r: (_n(r, 2, 2, 3),),
   lambda F, t: F.affine_grid(t, [2, 3, 5, 6], align_corners=False))
_f("scaled_dot_product_attention",
   lambda r: (_n(r, 2, 5, 3, 64), _n(r, 2, 7, 3, 64), _n(r, 2, 7, 3, 64)),
   lambda F, q, k, v: F.scaled_dot_product_attention(q, k, v), red=True)
_f("scaled_dot_product_attention",
   lambda r: (_n(r, 2, 5, 3, 8), _n(r, 2, 5, 3, 8), _n(r, 2, 5, 3, 8),
              np.where(np.tril(np.ones((5, 5))) > 0, 0.0, -1e9).astype(
                  np.float32)),
   lambda F, q, k, v, m: F.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=m),
   cid="scaled_dot_product_attention-mask")
_f("scaled_dot_product_attention",
   lambda r: (_n(r, 2, 3, 5, 64), _n(r, 2, 3, 5, 64), _n(r, 2, 3, 5, 64)),
   lambda F, q, k, v: F.scaled_dot_product_attention(
       q, k, v, is_causal=True, qkv_layout="bhsd"),
   cid="scaled_dot_product_attention-bhsd", red=True)
_f("label_smooth", lambda r: (np.eye(6, dtype=np.float32)[_i(r, 6, 4)],),
   lambda F, y: F.label_smooth(y, epsilon=0.2))
_f("diag_embed", lambda r: (_n(r, 3, 4),),
   lambda F, x: F.diag_embed(x, offset=1))

# -- options on other paths: channel-last formats, 'SAME' pads, ceil
# mode, custom trees, labels with a trailing 1 ---------------------------
_f("conv2d_transpose", lambda r: (_n(r, 2, 5, 5, 4), _n(r, 4, 3, 3, 3)),
   lambda F, x, w: F.conv2d_transpose(x, w, stride=2, padding=1,
                                      data_format="NHWC"),
   cid="conv2d_transpose-nhwc", red=True)
_f("conv1d", lambda r: (_n(r, 2, 4, 9), _n(r, 6, 4, 3)),
   lambda F, x, w: F.conv1d(x, w, stride=2, padding="SAME"),
   cid="conv1d-same")
_f("conv1d_transpose", lambda r: (_n(r, 2, 7, 4), _n(r, 4, 3, 3)),
   lambda F, x, w: F.conv1d_transpose(x, w, stride=2, padding=[1, 2],
                                      data_format="NLC"),
   cid="conv1d_transpose-nlc")
_f("conv3d", lambda r: (_n(r, 2, 3, 5, 6, 5), _n(r, 4, 3, 2, 3, 2)),
   lambda F, x, w: F.conv3d(x, w, stride=2, padding="SAME"),
   cid="conv3d-same", red=True)
_f("interpolate", lambda r: (_n(r, 2, 5, 7, 3),),
   lambda F, x: F.interpolate(x, size=[8, 4], mode="bilinear",
                              data_format="NHWC"), cid="interpolate-nhwc")
_f("interpolate", lambda r: (_n(r, 2, 3, 9),),
   lambda F, x: F.interpolate(x, size=[4], mode="linear",
                              data_format="NCW"), cid="interpolate-linear")
_f("pad", lambda r: (_n(r, 2, 4, 5, 3),),
   lambda F, x: F.pad(x, [1, 2, 2, 1], mode="reflect", data_format="NHWC"),
   cid="pad-nhwc")
_f("max_pool2d", lambda r: (_n(r, 2, 9, 9, 3),),
   lambda F, x: F.max_pool2d(x, 3, 2, "SAME", data_format="NHWC"),
   cid="max_pool2d-nhwc-same")
_f("avg_pool3d", lambda r: (_n(r, 2, 2, 6, 7, 5),),
   lambda F, x: F.avg_pool3d(x, 2, 2, 0, ceil_mode=True),
   cid="avg_pool3d-ceil")
_f("adaptive_avg_pool2d", lambda r: (_n(r, 2, 7, 9, 3),),
   lambda F, x: F.adaptive_avg_pool2d(x, [3, 4], data_format="NHWC"),
   cid="adaptive_avg_pool2d-nhwc")
_f("grid_sample", lambda r: (_n(r, 2, 3, 5, 6), _u(r, 2, 4, 4, 2, lo=-1.2,
                                                   hi=1.2)),
   lambda F, x, g: F.grid_sample(x, g, padding_mode="border",
                                 align_corners=False),
   cid="grid_sample-border")
_f("hsigmoid_loss",
   lambda r: (_n(r, 5, 8), _i(r, 6, 5), _n(r, 6, 8), _n(r, 6, 1),
              np.array([[0, 1, -1], [0, 2, 3], [1, 4, -1], [0, 1, 5],
                        [2, 3, -1]], np.int64), _i(r, 2, 5, 3)),
   lambda F, x, y, w, b, table, code: F.hsigmoid_loss(x, y, 6, w, b, table,
                                                      code),
   cid="hsigmoid_loss-custom")
_f("cross_entropy", lambda r: (_n(r, 6, 5), _i(r, 5, 6, 1)),
   lambda F, x, y: F.cross_entropy(x, y, reduction="none"),
   cid="cross_entropy-label-n1")
_f("nll_loss", lambda r: (_logp(r, 3, 4, 5).transpose(0, 2, 1).copy(),
                          _i(r, 5, 3, 4)),
   lambda F, x, y: F.nll_loss(x, y, reduction="sum"), cid="nll_loss-3d")

# -- layers ----------------------------------------------------------------
L_CASES = []


def _l(cls, ctor, make, call=None, **kw):
    L_CASES.append(Case(cls, make, (ctor, call), **kw))


_act = lambda r: (_n(r, 2, 3, 4, 4, scale=2.0),)  # noqa: E731
for _cls, _args in [
        ("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()), ("LogSigmoid", ()),
        ("Tanh", ()), ("Tanhshrink", ()), ("Silu", ()), ("Swish", ()),
        ("Mish", ()), ("Hardswish", ()), ("Softsign", ()), ("SELU", ()),
        ("GELU", (True,)), ("LeakyReLU", (0.1,)), ("ELU", (0.7,)),
        ("CELU", (0.8,)), ("Hardtanh", (-0.5, 0.7)), ("Hardsigmoid", ()),
        ("Hardshrink", (0.4,)), ("Softshrink", (0.3,)),
        ("Softplus", (2.0, 3.0)), ("PReLU", (3, 0.2)), ("Softmax", (0,)),
        ("LogSoftmax", (1,)), ("Maxout", (3,)), ("ThresholdedReLU", (0.5,))]:
    _l(_cls, (lambda c, a: lambda nn: getattr(nn, c)(*a))(_cls, _args), _act)

_l("Identity", lambda nn: nn.Identity(), _act)
_l("Flatten", lambda nn: nn.Flatten(1, 2), _act)
_l("Linear", lambda nn: nn.Linear(5, 4), lambda r: (_n(r, 3, 5),))
_l("Embedding", lambda nn: nn.Embedding(10, 4, padding_idx=2),
   lambda r: (_i(r, 10, 3, 5),))
_l("Dropout", lambda nn: nn.Dropout(0.3), _act, train=False)
_l("Dropout2D", lambda nn: nn.Dropout2D(0.3), _act, train=False)
_l("Dropout3D", lambda nn: nn.Dropout3D(0.3),
   lambda r: (_n(r, 2, 3, 2, 3, 3),), train=False)
_l("AlphaDropout", lambda nn: nn.AlphaDropout(0.3), _act, train=False)
_l("Upsample", lambda nn: nn.Upsample(size=[6, 3], mode="bilinear"), _act)
_l("UpsamplingBilinear2D", lambda nn: nn.UpsamplingBilinear2D(
    scale_factor=2), _act)
_l("UpsamplingNearest2D", lambda nn: nn.UpsamplingNearest2D(size=[7, 5]),
   _act)
_l("Pad1D", lambda nn: nn.Pad1D([1, 2], mode="reflect"),
   lambda r: (_n(r, 2, 3, 6),))
_l("Pad2D", lambda nn: nn.Pad2D([1, 0, 2, 1], mode="replicate"), _act)
_l("Pad3D", lambda nn: nn.Pad3D([1, 1, 0, 1, 1, 0], value=0.5),
   lambda r: (_n(r, 1, 2, 3, 3, 3),))
_l("PixelShuffle", lambda nn: nn.PixelShuffle(2),
   lambda r: (_n(r, 2, 8, 3, 3),))
_l("Unfold", lambda nn: nn.Unfold([2, 2]), _act)
_l("CosineSimilarity", lambda nn: nn.CosineSimilarity(axis=1),
   lambda r: (_n(r, 4, 6), _n(r, 4, 6)))
_l("PairwiseDistance", lambda nn: nn.PairwiseDistance(p=1.5),
   lambda r: (_n(r, 4, 6), _n(r, 4, 6)))
_l("Bilinear", lambda nn: nn.Bilinear(3, 4, 5),
   lambda r: (_n(r, 6, 3), _n(r, 6, 4)))
_l("Conv1D", lambda nn: nn.Conv1D(4, 6, 3, padding=1),
   lambda r: (_n(r, 2, 4, 9),), red=True)
_l("Conv2D", lambda nn: nn.Conv2D(4, 6, 3, stride=2, padding=1),
   lambda r: (_n(r, 2, 4, 7, 7),), red=True)
_l("Conv3D", lambda nn: nn.Conv3D(3, 4, 2),
   lambda r: (_n(r, 2, 3, 4, 5, 4),), red=True)
_l("Conv1DTranspose", lambda nn: nn.Conv1DTranspose(4, 3, 3, stride=2),
   lambda r: (_n(r, 2, 4, 7),), red=True)
_l("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(
    4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
   lambda r: (_n(r, 2, 4, 5, 5),), red=True)
_l("Conv3DTranspose", lambda nn: nn.Conv3DTranspose(4, 2, 2, stride=2),
   lambda r: (_n(r, 1, 4, 3, 3, 2),), red=True)
for _cls, _shape in [("BatchNorm", (8, 3, 4, 4)), ("BatchNorm1D", (8, 3)),
                     ("BatchNorm2D", (8, 3, 4, 4)),
                     ("BatchNorm3D", (4, 3, 2, 3, 3))]:
    _l(_cls, (lambda c: lambda nn: getattr(nn, c)(3))(_cls),
       (lambda s: lambda r: (_n(r, *s, scale=2.0),))(_shape), red=True)
_l("GroupNorm", lambda nn: nn.GroupNorm(3, 6),
   lambda r: (_n(r, 2, 6, 4, 4, scale=2.0),))
_l("InstanceNorm1D", lambda nn: nn.InstanceNorm1D(3),
   lambda r: (_n(r, 2, 3, 7, scale=2.0),))
_l("InstanceNorm2D", lambda nn: nn.InstanceNorm2D(3), _act)
_l("InstanceNorm3D", lambda nn: nn.InstanceNorm3D(3),
   lambda r: (_n(r, 2, 3, 2, 3, 3, scale=2.0),))
_l("LayerNorm", lambda nn: nn.LayerNorm([4, 6]),
   lambda r: (_n(r, 3, 4, 6, scale=2.0),))
_l("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(3, alpha=0.1),
   lambda r: (_n(r, 2, 6, 4, 4),))
_l("RMSNorm", lambda nn: nn.RMSNorm(6), lambda r: (_n(r, 3, 6, scale=2.0),))
_l("SpectralNorm", lambda nn: nn.SpectralNorm([5, 6], dim=1, power_iters=2),
   lambda r: (_n(r, 5, 6),))
for _cls, _a, _shape in [
        ("MaxPool1D", (3, 2, 1), (2, 3, 11)),
        ("MaxPool2D", (3, 2, 1), (2, 3, 9, 9)),
        ("MaxPool3D", (2,), (2, 2, 6, 7, 5)),
        ("AvgPool1D", (3, 2, 1), (2, 3, 11)),
        ("AvgPool2D", (3, 2, 1, False, False), (2, 3, 9, 9)),
        ("AvgPool3D", (2, None, 1), (2, 2, 6, 7, 5)),
        ("AdaptiveAvgPool1D", (4,), (2, 3, 10)),
        ("AdaptiveAvgPool2D", ([3, 4],), (2, 3, 7, 9)),
        ("AdaptiveAvgPool3D", ([2, 3, 3],), (2, 2, 5, 6, 7)),
        ("AdaptiveMaxPool1D", (4,), (2, 3, 10)),
        ("AdaptiveMaxPool2D", ([3, 4],), (2, 3, 7, 9)),
        ("AdaptiveMaxPool3D", ([2, 3, 3],), (2, 2, 5, 6, 7))]:
    _l(_cls, (lambda c, a: lambda nn: getattr(nn, c)(*a))(_cls, _a),
       (lambda s: lambda r: (_n(r, *s),))(_shape))

# losses as layers
_l("MSELoss", lambda nn: nn.MSELoss(), lambda r: (_n(r, 4, 5), _n(r, 4, 5)))
_l("L1Loss", lambda nn: nn.L1Loss(), lambda r: (_n(r, 4, 5), _n(r, 4, 5)))
_l("SmoothL1Loss", lambda nn: nn.SmoothL1Loss(delta=0.5),
   lambda r: (_n(r, 4, 5), _n(r, 4, 5)))
_l("NLLLoss", lambda nn: nn.NLLLoss(),
   lambda r: (_logp(r, 6, 5), _labels_with_ignored(r)))
_l("BCELoss", lambda nn: nn.BCELoss(),
   lambda r: (_u(r, 4, 5, lo=0.02, hi=0.98),
              _i(r, 2, 4, 5).astype(np.float32)))
_l("BCEWithLogitsLoss", lambda nn: nn.BCEWithLogitsLoss(),
   lambda r: (_n(r, 4, 5), _i(r, 2, 4, 5).astype(np.float32)))
_l("KLDivLoss", lambda nn: nn.KLDivLoss("sum"),
   lambda r: (_logp(r, 4, 6), np.exp(_logp(r, 4, 6))))
_l("MarginRankingLoss", lambda nn: nn.MarginRankingLoss(0.1),
   lambda r: (_n(r, 6), _n(r, 6),
              (2 * _i(r, 2, 6) - 1).astype(np.float32)))
_l("CTCLoss", lambda nn: nn.CTCLoss(), _ctc)
_l("HSigmoidLoss", lambda nn: nn.HSigmoidLoss(8, 6),
   lambda r: (_n(r, 5, 8), _i(r, 6, 5)))
_l("CrossEntropyLoss", lambda nn: nn.CrossEntropyLoss(soft_label=True),
   lambda r: (_n(r, 6, 5), np.exp(_logp(r, 6, 5))))

# containers
_l("Sequential", lambda nn: nn.Sequential(nn.Linear(5, 4), nn.ReLU(),
                                          nn.Linear(4, 3)),
   lambda r: (_n(r, 3, 5),))
_l("LayerList", lambda nn: nn.LayerList([nn.Linear(5, 5), nn.Tanh(),
                                         nn.Linear(5, 2)]),
   lambda r: (_n(r, 3, 5),),
   lambda m, x: m[2](m[1](m[0](x))))
_l("LayerDict", lambda nn: nn.LayerDict({"a": nn.Linear(5, 4),
                                         "b": nn.Sigmoid()}),
   lambda r: (_n(r, 3, 5),), lambda m, x: m["b"](m["a"](x)))

# attention and the transformer (head_dim 32, a width the CUDA kernels
# take); dropout 0, so training mode runs the same arithmetic as eval
TF = dict(d_model=64, nhead=2, dim_feedforward=96, dropout=0.0)


def _seq(r, b=2, s=6):
    return _n(r, b, s, TF["d_model"])


def _causal(s):
    return np.where(np.tril(np.ones((s, s))) > 0, 0.0, -1e9).astype(
        np.float32)


_l("MultiHeadAttention", lambda nn: nn.MultiHeadAttention(64, 2),
   lambda r: (_seq(r), _seq(r, s=9)), lambda m, q, kv: m(q, kv, kv),
   red=True)
_l("TransformerEncoderLayer", lambda nn: nn.TransformerEncoderLayer(
    64, 2, 96, dropout=0.0), lambda r: (_seq(r),), red=True)
_l("TransformerEncoder", lambda nn: nn.TransformerEncoder(
    nn.TransformerEncoderLayer(64, 2, 96, dropout=0.0,
                               normalize_before=True), 2, nn.LayerNorm(64)),
   lambda r: (_seq(r),), red=True)
_l("TransformerDecoderLayer", lambda nn: nn.TransformerDecoderLayer(
    64, 2, 96, dropout=0.0), lambda r: (_seq(r), _seq(r, s=7), _causal(6)),
   lambda m, t, mem, mask: m(t, mem, tgt_mask=mask), red=True)
_l("TransformerDecoder", lambda nn: nn.TransformerDecoder(
    nn.TransformerDecoderLayer(64, 2, 96, dropout=0.0), 2),
   lambda r: (_seq(r), _seq(r, s=7), _causal(6)),
   lambda m, t, mem, mask: m(t, mem, tgt_mask=mask), red=True)
_l("Transformer", lambda nn: nn.Transformer(64, 2, 2, 2, 96, dropout=0.0),
   lambda r: (_seq(r, s=7), _seq(r), _causal(6)),
   lambda m, src, tgt, mask: m(src, tgt, tgt_mask=mask), red=True)

# recurrent layers
_l("SimpleRNNCell", lambda nn: nn.SimpleRNNCell(5, 7),
   lambda r: (_n(r, 3, 5), _n(r, 3, 7)))
_l("LSTMCell", lambda nn: nn.LSTMCell(5, 7),
   lambda r: (_n(r, 3, 5), _n(r, 3, 7), _n(r, 3, 7)),
   lambda m, x, h, c: m(x, (h, c)))
_l("GRUCell", lambda nn: nn.GRUCell(5, 7),
   lambda r: (_n(r, 3, 5), _n(r, 3, 7)))
_l("RNN", lambda nn: nn.RNN(nn.GRUCell(5, 7), is_reverse=True),
   lambda r: (_n(r, 3, 4, 5),))
_l("BiRNN", lambda nn: nn.BiRNN(nn.LSTMCell(5, 7), nn.LSTMCell(5, 7)),
   lambda r: (_n(r, 3, 4, 5),))
_l("SimpleRNN", lambda nn: nn.SimpleRNN(5, 7, 2, direction="bidirect"),
   lambda r: (_n(r, 3, 4, 5),))
_l("LSTM", lambda nn: nn.LSTM(5, 7, 2, direction="bidirect"),
   lambda r: (_n(r, 3, 4, 5),))
_l("GRU", lambda nn: nn.GRU(5, 7, 2, time_major=True),
   lambda r: (_n(r, 4, 3, 5),))


def layer_values(state, seed=0):
    """{name: f32 array} of random values for a layer's state: matrices
    N(0, 1 / fan_in) with the reference's fans (a [in, out] matrix's
    first dim, a conv weight's in * prod(k)), so activations stay O(1);
    vectors N(0, 0.3); variances and norm scales in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in state.items():
        if name.endswith("_variance") or (
                "norm" in name and name.endswith("weight")):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            fan_in = shape[0] if len(shape) == 2 else \
                int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            v = rng.standard_normal(shape) * 0.3
        out[name] = v.astype(np.float32)
    return out


# names of the reference's nn that these tables do not cover with a
# parity case, each for a reason
NOT_SWEPT = {
    "Layer": "the base class, exercised by every layer",
    "Parameter": "the parameter class",
    "ParameterList": "a container of parameters with no forward "
                     "(test_torch_nn_layers.py checks its names)",
    "RNNCellBase": "the cells' base class (get_initial_states, tested "
                   "through the cells)",
    "BeamSearchDecoder": "no forward of its own: against brute force in "
                         "test_torch_rnn_decode.py",
    "dynamic_decode": "drives BeamSearchDecoder (test_torch_rnn_decode.py)",
    "spectral_norm": "nn.utils reparameterisation (test_torch_nn_layers.py)",
    "ClipGradByGlobalNorm": "gradient clipping (test_torch_clip_io.py)",
    "ClipGradByNorm": "gradient clipping (test_torch_clip_io.py)",
    "ClipGradByValue": "gradient clipping (test_torch_clip_io.py)",
}

# functional ops whose parity cases are property tests (their draws
# cannot repeat the reference's), besides their eval-mode cases above
RANDOM_FUNCTIONS = ("dropout", "dropout2d", "dropout3d", "alpha_dropout",
                    "gumbel_softmax")

# the reference's nn and nn.functional names that wait (ROADMAP.md)
WAITING = {"SyncBatchNorm": "queue A item 4 (the distributed slice)",
           "quant": "queue A item 5 (nn.quant)"}
