"""nn.functional (counterpart of paddle_tpu/nn/functional): every public
function of the reference, with its signature and arithmetic.

AMP: each op first passes its tensor inputs through `amp.cast` under the
op name that the reference dispatches (``matmul_v2`` for `linear`,
``logsigmoid`` for `log_sigmoid`, ``lookup_table_v2`` for `embedding`,
...), so under ``amp.auto_cast`` O1 the ops of the black list compute in
float32, those of the white list in the low dtype, and the others keep
their inputs' dtype, and under O2 every op not black-listed computes in
the low dtype, as in the reference. Functions that the reference
composes from other ops and Tensor operators or methods
(`pairwise_distance`, `glu`, `label_smooth`, `gumbel_softmax`,
`sigmoid_focal_loss`, a conv's bias ``out + bias.reshape(...)``) compose
the same ops here, each cast under its own name (`_t`, `amp.binary`).

Random ops draw from the generator that `framework.random.rng_scope`
installs (an engine's), else from torch's default one; they cannot
repeat the reference's JAX streams bit for bit. `fused_conv2d_bn_act`
also applies its own cast rule inside (x, w and the residual in the low
dtype under O1). The batch-norm ops return y and write the new
running stats into the given buffers in place under ``no_grad`` (the
reference's ``set_value``), in training unless `use_global_stats`.
``embedding(sparse=True)`` (SelectedRows gradients) is not ported.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as tF

from ... import amp
from ...framework import random as _random
from ...ops import extra_ops, fused_conv, fused_loss, fused_ops, lowp, \
    nn_ops

__all__ = [
    # activations
    "relu", "relu6", "gelu", "sigmoid", "log_sigmoid", "tanh", "silu",
    "swish", "mish", "leaky_relu", "elu", "celu", "selu", "prelu",
    "hardtanh", "hardsigmoid", "hardswish", "hardshrink", "softshrink",
    "softplus", "softsign", "tanhshrink", "softmax", "log_softmax",
    "gumbel_softmax", "maxout", "thresholded_relu", "glu",
    # linear, conv, pooling
    "linear", "matmul", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "max_pool1d", "max_pool2d",
    "max_pool3d", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    # normalisation, dropout, embedding
    "layer_norm", "batch_norm", "fused_bn_act", "fused_conv2d_bn_act",
    "instance_norm", "group_norm", "normalize", "local_response_norm",
    "dropout", "dropout2d", "dropout3d", "alpha_dropout", "embedding",
    "one_hot",
    # losses and distances
    "cross_entropy", "fused_linear_cross_entropy",
    "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "square_error_cost",
    "l1_loss", "ctc_loss", "npair_loss", "smooth_l1_loss", "nll_loss",
    "kl_div", "margin_ranking_loss", "sigmoid_focal_loss", "hsigmoid_loss",
    "cosine_similarity", "pairwise_distance",
    # shape, resize, attention
    "pad", "interpolate", "upsample", "pixel_shuffle", "unfold",
    "temporal_shift", "grid_sample", "affine_grid",
    "scaled_dot_product_attention", "label_smooth", "diag_embed",
]

# additive mask value of the reference's attention paths (a large finite
# negative, not -inf, so a fully masked row cannot turn into NaN)
NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}


def _dtype(d):
    return _DTYPES.get(d, d) if isinstance(d, str) else d


def _reduce(loss, reduction):
    """A reduction inside a reference op (no AMP cast of its own)."""
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else loss.mean()


def _sum(x, **kw):
    """The reference's ``Tensor.sum`` (op ``reduce_sum``, AMP black
    list)."""
    (x,) = amp.cast("reduce_sum", x)
    return x.sum(**kw)


def _mean(x):
    (x,) = amp.cast("reduce_mean", x)
    return x.mean()


def _t(op_name, x):
    """`x` as the reference's Tensor method `op_name` (``reshape``,
    ``transpose``, ``unsqueeze``, ...) receives it: cast by `amp.cast`
    (under O2 to the low dtype; under O1 these names are unlisted)."""
    (x,) = amp.cast(op_name, x)
    return x


_add, _sub, _mul, _div = (
    functools.partial(amp.binary, f"elementwise_{name}")
    for name in ("add", "sub", "mul", "div"))


def _reduce_t(loss, reduction):
    """A reduction the reference applies with ``Tensor.sum`` /
    ``Tensor.mean`` after its op."""
    if reduction == "none":
        return loss
    return _sum(loss) if reduction == "sum" else _mean(loss)


# -- activations -----------------------------------------------------------


def relu(x, name=None):
    (x,) = amp.cast("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = amp.cast("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False, name=None):
    (x,) = amp.cast("gelu", x)
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    (x,) = amp.cast("sigmoid", x)
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    (x,) = amp.cast("logsigmoid", x)
    return tF.logsigmoid(x)


def tanh(x, name=None):
    (x,) = amp.cast("tanh", x)
    return torch.tanh(x)


def silu(x, name=None):
    (x,) = amp.cast("silu", x)
    return tF.silu(x)


def swish(x, name=None):
    (x,) = amp.cast("swish", x)
    return tF.silu(x)


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mish(x, name=None):
    (x,) = amp.cast("mish", x)
    return x * torch.tanh(_softplus(x))


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = amp.cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = amp.cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(torch.clamp_max(x, 0)))


def celu(x, alpha=1.0, name=None):
    (x,) = amp.cast("celu", x)
    return torch.where(x > 0, x,
                       alpha * torch.expm1(torch.clamp_max(x, 0) / alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = amp.cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def prelu(x, weight, name=None):
    x, weight = amp.cast("prelu", x, weight)
    return torch.where(x >= 0, x, weight * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = amp.cast("hardtanh", x)
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    (x,) = amp.cast("hardsigmoid", x)
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    (x,) = amp.cast("hardswish", x)
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = amp.cast("softplus", x)
    scaled = x * beta
    return torch.where(scaled > threshold, x, _softplus(scaled) / beta)


def softsign(x, name=None):
    (x,) = amp.cast("softsign", x)
    return x / (1 + x.abs())


def tanhshrink(x, name=None):
    (x,) = amp.cast("tanh_shrink", x)
    return x - torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """AMP black list: computed in float32 under O1."""
    (x,) = amp.cast("softmax", x)
    out = torch.softmax(x, dim=axis)
    return out.to(_dtype(dtype)) if dtype is not None else out


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp.cast("log_softmax", x)
    out = torch.log_softmax(x, dim=axis)
    return out.to(_dtype(dtype)) if dtype is not None else out


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel noise g from the
    installed generator; `hard` gives the straight-through one-hot."""
    u = torch.rand(tuple(x.shape), generator=_random.generator_for(
        x.device), device=x.device)
    g = -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))
    y = softmax((x + g) / temperature, axis=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        oh = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        return oh + y - y.detach()
    return y


def maxout(x, groups, axis=1, name=None):
    (x,) = amp.cast("maxout", x)
    return extra_ops.maxout(x, groups=groups, axis=axis)


def thresholded_relu(x, threshold=1.0, name=None):
    (x,) = amp.cast("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def glu(x, axis=-1, name=None):
    a, b = _t("split", x).chunk(2, dim=axis)
    return _mul(a, sigmoid(b))


# -- linear / conv ---------------------------------------------------------


def matmul(x, y, transpose_y=False):
    """The reference's ``matmul_v2`` (AMP white list)."""
    x, y = amp.cast("matmul_v2", x, y)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W in paddle's [in, out] layout: a ``matmul_v2``
    then an add outside the AMP lists, so under bf16 auto_cast a bf16
    product plus an f32 bias promotes to f32, as in the reference.
    With ``FLAGS_lowp_matmul`` on, `ops.lowp.maybe_linear` is asked
    first: a routed product reads the raw operands (no amp cast) and
    comes back in their promoted dtype."""
    y = lowp.maybe_linear(x, weight)
    if y is None:
        y = matmul(x, weight)
    return y if bias is None else _add(y, bias)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """AMP white list; the bias is added outside the op (it promotes a
    low-precision conv to float32, as in the reference)."""
    x, weight = amp.cast("conv2d", x, weight)
    out = nn_ops.conv2d(x, weight, stride=stride, padding=padding,
                        dilation=dilation, groups=groups,
                        data_format=data_format)
    if bias is not None:
        shape = [1, -1, 1, 1] if data_format == "NCHW" else [1, 1, 1, -1]
        out = _add(out, _t("reshape", bias).reshape(shape))
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    x, weight = amp.cast("conv1d", x, weight)
    out = nn_ops.conv1d(x, weight, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)
    return out if bias is None else _add(
        out, _t("reshape", bias).reshape([1, -1, 1]))


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    x, weight = amp.cast("conv3d", x, weight)
    out = nn_ops.conv3d(x, weight, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)
    return out if bias is None else _add(
        out, _t("reshape", bias).reshape([1, -1, 1, 1, 1]))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", name=None):
    x, weight = amp.cast("conv2d_transpose", x, weight)
    out = nn_ops.conv_transpose(
        x, weight, 2, stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation, groups=groups,
        data_format=data_format)
    if bias is not None:
        shape = [1, -1, 1, 1] if data_format == "NCHW" else [1, 1, 1, -1]
        out = _add(out, _t("reshape", bias).reshape(shape))
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL", name=None):
    """A 2-D transposed conv over ``x[:, :, None, :]`` (the reference's
    lowering, op ``conv2d_transpose``)."""
    def _one(v):
        return v if isinstance(v, int) else v[0]

    if data_format == "NLC":
        x = _t("transpose", x).transpose(1, 2)
    if isinstance(padding, str):
        pad = padding
    elif (isinstance(padding, (list, tuple)) and len(padding) == 2
            and all(isinstance(p, int) for p in padding)):
        pad = [(0, 0), (padding[0], padding[1])]
    else:
        pad = (0, _one(padding))
    x, weight = (_t("unsqueeze", t).unsqueeze(2) for t in (x, weight))
    x, weight = amp.cast("conv2d_transpose", x, weight)
    out = nn_ops.conv_transpose(
        x, weight, 2, stride=(1, _one(stride)),
        padding=pad, output_padding=(0, _one(output_padding)),
        dilation=(1, _one(dilation)), groups=groups)
    out = _t("squeeze", out).squeeze(2)
    if bias is not None:
        out = _add(out, _t("reshape", bias).reshape([1, -1, 1]))
    return _t("transpose", out).transpose(1, 2) if data_format == "NLC" \
        else out


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW", name=None):
    x, weight = amp.cast("conv3d_transpose", x, weight)
    out = nn_ops.conv_transpose(
        x, weight, 3, stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation, groups=groups,
        data_format=data_format)
    if bias is not None:
        shape = [1, -1, 1, 1, 1] if data_format == "NCDHW" \
            else [1, 1, 1, 1, -1]
        out = _add(out, _t("reshape", bias).reshape(shape))
    return out


# -- pooling ---------------------------------------------------------------


def _first(v):
    return v if v is None or isinstance(v, int) else v[0]


def _pool_1d_args(kernel_size, stride, padding):
    """(ksize, stride, padding) of the reference's 1-D pools, which pool
    ``x[:, :, None, :]`` over (1, k)."""
    k, s = _first(kernel_size), _first(stride)
    pad = padding if isinstance(padding, str) else \
        (0, padding if isinstance(padding, int) else padding[0])
    return (1, k), (1, s if s is not None else k), pad


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """With `return_mask`, also the flat index of each maximum into the
    input's H * W map (NCHW, numeric padding, no ceil_mode, as the
    reference's ``max_pool2d_with_index``)."""
    if return_mask:
        if ceil_mode or data_format != "NCHW" or isinstance(padding, str):
            raise NotImplementedError(
                "max_pool2d(return_mask=True) supports NCHW with numeric "
                "padding and no ceil_mode (reference pool_with_index "
                "constraint)")
        (x,) = amp.cast("max_pool2d_with_index", x)
        ks = nn_ops._pair(kernel_size)
        st = ks if stride is None else nn_ops._pair(stride)
        return nn_ops.max_pool_with_index(x, ks, st,
                                          nn_ops._pair(padding))
    (x,) = amp.cast("pool2d", x)
    return nn_ops.pool2d(x, ksize=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         pooling_type="max", data_format=data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    (x,) = amp.cast("pool2d", x)
    return nn_ops.pool2d(x, ksize=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         pooling_type="avg", exclusive=exclusive,
                         data_format=data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    (x,) = amp.cast("pool2d", x)
    return nn_ops.pool2d(x, ksize=output_size, adaptive=True,
                         pooling_type="avg", data_format=data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        (x,) = amp.cast("max_pool2d_with_index", x)
        return nn_ops.adaptive_max_pool_with_index(
            x, nn_ops._pair(output_size))
    (x,) = amp.cast("pool2d", x)
    return nn_ops.pool2d(x, ksize=output_size, adaptive=True,
                         pooling_type="max")


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, name=None):
    ks, st, pad = _pool_1d_args(kernel_size, stride, padding)
    if return_mask:
        if ceil_mode or isinstance(padding, str):
            raise NotImplementedError(
                "max_pool1d(return_mask=True) needs numeric padding and "
                "no ceil_mode (reference pool_with_index constraint)")
        (x,) = amp.cast("max_pool2d_with_index",
                        _t("unsqueeze", x).unsqueeze(2))
        # on the (1, L) map the flat index is the position along L
        out, idx = nn_ops.max_pool_with_index(x, ks, st, pad)
        return _t("squeeze", out).squeeze(2), idx.squeeze(2)
    (x,) = amp.cast("pool2d", _t("unsqueeze", x).unsqueeze(2))
    return _t("squeeze", nn_ops.pool2d(
        x, ksize=ks, stride=st, padding=pad, ceil_mode=ceil_mode,
        pooling_type="max")).squeeze(2)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, name=None):
    ks, st, pad = _pool_1d_args(kernel_size, stride, padding)
    (x,) = amp.cast("pool2d", _t("unsqueeze", x).unsqueeze(2))
    return _t("squeeze", nn_ops.pool2d(
        x, ksize=ks, stride=st, padding=pad, ceil_mode=ceil_mode,
        pooling_type="avg", exclusive=exclusive)).squeeze(2)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        if ceil_mode or data_format != "NCDHW" or isinstance(padding, str):
            raise NotImplementedError(
                "max_pool3d(return_mask=True) supports NCDHW with numeric "
                "padding and no ceil_mode (reference pool_with_index "
                "constraint)")
        (x,) = amp.cast("max_pool3d_with_index", x)
        ks = nn_ops._pair(kernel_size, 3)
        st = ks if stride is None else nn_ops._pair(stride, 3)
        return nn_ops.max_pool_with_index(x, ks, st,
                                          nn_ops._pair(padding, 3))
    (x,) = amp.cast("pool3d", x)
    return extra_ops.pool3d(x, ksize=kernel_size, stride=stride,
                            padding=padding, ceil_mode=ceil_mode,
                            pooling_type="max", data_format=data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    (x,) = amp.cast("pool3d", x)
    return extra_ops.pool3d(x, ksize=kernel_size, stride=stride,
                            padding=padding, ceil_mode=ceil_mode,
                            pooling_type="avg", exclusive=exclusive,
                            data_format=data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    (x,) = amp.cast("pool2d", _t("unsqueeze", x).unsqueeze(2))
    return _t("squeeze", nn_ops.pool2d(
        x, ksize=(1, output_size), adaptive=True,
        pooling_type="avg")).squeeze(2)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        (x,) = amp.cast("max_pool2d_with_index",
                        _t("unsqueeze", x).unsqueeze(2))
        out, idx = nn_ops.adaptive_max_pool_with_index(x, (1, output_size))
        return _t("squeeze", out).squeeze(2), idx.squeeze(2)
    (x,) = amp.cast("pool2d", _t("unsqueeze", x).unsqueeze(2))
    return _t("squeeze", nn_ops.pool2d(
        x, ksize=(1, output_size), adaptive=True,
        pooling_type="max")).squeeze(2)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    (x,) = amp.cast("pool3d", x)
    return extra_ops.pool3d(x, ksize=output_size, adaptive=True,
                            pooling_type="avg", data_format=data_format)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        (x,) = amp.cast("max_pool3d_with_index", x)
        return nn_ops.adaptive_max_pool_with_index(
            x, nn_ops._pair(output_size, 3))
    (x,) = amp.cast("pool3d", x)
    return extra_ops.pool3d(x, ksize=output_size, adaptive=True,
                            pooling_type="max")


# -- normalisation ---------------------------------------------------------


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """AMP black list: normalised in float32."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp.cast("layer_norm", x, weight, bias)
    shape = list(normalized_shape)
    if weight is not None:
        weight = weight.reshape(shape)
    if bias is not None:
        bias = bias.reshape(shape)
    return tF.layer_norm(x, shape, weight, bias, epsilon)


def _write_stats(running_mean, running_var, new_mean, new_var):
    with torch.no_grad():
        running_mean.copy_(new_mean)
        running_var.copy_(new_var)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """AMP black list: every tensor enters in float32. NC... or channel
    last ("NHWC" and the like)."""
    if use_global_stats is None:
        use_global_stats = not training
    xs, w, b, mean, var = amp.cast("batch_norm", x, weight, bias,
                                   running_mean, running_var)
    y, (new_mean, new_var) = nn_ops.batch_norm(
        xs, w, b, mean, var, momentum=momentum, epsilon=epsilon,
        is_test=not training, data_format=data_format,
        use_global_stats=use_global_stats)
    if training and not use_global_stats:
        _write_stats(running_mean, running_var, new_mean, new_var)
    return y


def fused_bn_act(x, running_mean, running_var, weight, bias,
                 residual=None, act="relu", training=False, momentum=0.9,
                 epsilon=1e-5, data_format="NCHW", use_global_stats=None,
                 name=None):
    """act(batch_norm(x) [+ residual]) through the minimal-residual VJP
    (`ops.nn_ops._BnActCore`): the backward recomputes the normalised
    activation instead of saving y or a mask."""
    if use_global_stats is None:
        use_global_stats = not training
    # under O2 the op takes every floating input in the low dtype; the
    # running stats are written back in their own dtype
    xs, w, b, mean, var, res = amp.cast("fused_bn_act", x, weight, bias,
                                        running_mean, running_var,
                                        residual)
    y, (new_mean, new_var) = nn_ops.fused_bn_act(
        xs, w, b, mean, var, res,
        momentum=momentum, epsilon=epsilon, act=act, is_test=not training,
        data_format=data_format, use_global_stats=use_global_stats)
    if training and not use_global_stats:
        _write_stats(running_mean, running_var, new_mean, new_var)
    return y


def fused_conv2d_bn_act(x, weight, running_mean, running_var, bn_weight,
                        bn_bias, residual=None, act="relu", training=False,
                        momentum=0.9, epsilon=1e-5, stride=1, padding=0,
                        dilation=1, groups=1, data_format="NCHW",
                        use_global_stats=None, name=None):
    """act(batch_norm(conv2d(x, weight)) [+ residual]) through the
    fused-epilogue conv (`ops.fused_conv`, kernel B10 on CUDA tensors):
    eval folds the BN into the conv's epilogue, training takes the BN
    moments from the conv's accumulator."""
    if use_global_stats is None:
        use_global_stats = not training
    xs, w, g, b, mean, var, res = amp.cast(
        "fused_conv2d_bn_act", x, weight, bn_weight, bn_bias, running_mean,
        running_var, residual)
    y, (new_mean, new_var) = fused_conv.fused_conv2d_bn_act(
        xs, w, g, b, mean, var, res,
        stride=stride, padding=padding, dilation=dilation, groups=groups,
        momentum=momentum, epsilon=epsilon, act=act, is_test=not training,
        data_format=data_format, use_global_stats=use_global_stats)
    if training and not use_global_stats:
        _write_stats(running_mean, running_var, new_mean, new_var)
    return y


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    x, weight, bias = amp.cast("instance_norm", x, weight, bias)
    return nn_ops.instance_norm(x, weight, bias, epsilon=eps)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = amp.cast("group_norm", x, weight, bias)
    return nn_ops.group_norm(x, weight, bias, epsilon=epsilon,
                             groups=num_groups)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    if p == 2:
        (x,) = amp.cast("l2_normalize", x)
        return nn_ops.l2_normalize(x, axis=axis, epsilon=epsilon)
    (xn,) = amp.cast("p_norm", x)
    if p == float("inf"):
        norm = xn.abs().amax(dim=axis, keepdim=True)
    elif p == float("-inf"):
        norm = xn.abs().amin(dim=axis, keepdim=True)
    elif p == 0:
        norm = (xn != 0).to(xn.dtype).sum(dim=axis, keepdim=True)
    else:
        norm = (xn.abs() ** float(p)).sum(dim=axis, keepdim=True) \
            ** (1.0 / float(p))
    return x / torch.clamp_min(norm, epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, name=None):
    (x,) = amp.cast("local_response_norm", x)
    return nn_ops.local_response_norm(x, size=size, alpha=alpha, beta=beta,
                                      k=k)


# -- dropout ---------------------------------------------------------------


def _keep_mask(x, p, shape=None):
    """A keep mask of rate 1 - `p` over `shape` (x's by default), from
    the installed generator (`framework.random`)."""
    return torch.empty(tuple(x.shape) if shape is None else shape,
                       device=x.device).bernoulli_(
        1.0 - p, generator=_random.generator_for(x.device)).bool()


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Upscale-in-train dropout (kept values times ``1 / (1 - p)`` in x's
    dtype); "downscale_in_infer" keeps values as they are in training
    and multiplies by ``1 - p`` in eval. `axis` is accepted and, as in
    the reference, the mask covers every element. Inside a meshed
    engine's step the mask is the hash of the element's global
    coordinates (`framework.random.DropoutLayout`), else a draw from
    the installed generator."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return _mul(x, 1.0 - p)
        return x
    (x,) = amp.cast("dropout", x)
    layout = _random.layout_for(x.device)
    keep = _keep_mask(x, p) if layout is None else \
        layout.hidden_keep(x, fused_ops._thresh(p))
    scale = torch.tensor(1.0 / (1.0 - p) if mode == "upscale_in_train"
                         else 1.0, dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _channel_dropout(x, p, training, channel_last):
    if not training or p == 0.0:
        return x
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    shape[-1 if channel_last else 1] = x.shape[-1 if channel_last else 1]
    return x * _keep_mask(x, p, shape).to(x.dtype) / (1.0 - p)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels of a 4-D input dropped, the rest scaled by
    ``1 / (1 - p)``."""
    return _channel_dropout(x, p, training, data_format != "NCHW")


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return _channel_dropout(x, p, training, data_format != "NCDHW")


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped units take alpha' = -alpha *
    scale, then an affine correction restores the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = _keep_mask(x, p).to(x.dtype)
    return (x * keep + alpha_p * (1 - keep)) * a + b


# -- embedding -------------------------------------------------------------


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids of `x`; rows at `padding_idx` are
    zero in the output (so their gradient is zero)."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True) (SelectedRows gradients) is not ported")
    x, weight = amp.cast("lookup_table_v2", x, weight)
    out = tF.embedding(x.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows, as ``jax.nn.one_hot``."""
    (x,) = amp.cast("one_hot", x)
    return tF.one_hot(x.long(), num_classes).float()


# -- losses ----------------------------------------------------------------


def _hard_labels(label, ndim, axis):
    lbl = label
    if lbl.dim() == ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    return lbl.long()


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross entropy over `axis` in float32 (AMP black list).
    Hard labels: rows at `ignore_index` contribute 0, `weight` scales
    each row by its class's weight and "mean" divides by the sum of the
    gathered weights of the other rows (else by their count, at least
    1). Soft labels: ``-sum(label * log p)``. ``use_softmax=False``
    reads `input` as probabilities."""
    logits, label, weight = amp.cast("cross_entropy", input, label, weight)
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=axis) if use_softmax \
        else torch.log(torch.clamp_min(logits, 1e-30))
    w = None
    if soft_label:
        loss = -(label * logp).sum(dim=axis)
        valid = torch.ones_like(loss, dtype=torch.bool)
    else:
        lbl = _hard_labels(label, input.dim(), axis)
        idx = lbl.clamp_min(0).unsqueeze(axis)
        loss = -torch.gather(logp, axis, idx).squeeze(axis)
        valid = lbl != ignore_index
        loss = loss * valid.to(loss.dtype)
        if weight is not None:
            # a constant, as the reference's op attribute
            w = weight.detach()[lbl.clamp_min(0)]
            loss = loss * w
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if w is not None:
        denom = torch.clamp_min((w * valid.to(loss.dtype)).sum(), 1e-12)
    else:
        denom = torch.clamp_min(valid.to(loss.dtype).sum(), 1.0)
    return loss.sum() / denom


def fused_linear_cross_entropy(hidden, weight, label, ignore_index=-100,
                               reduction="mean", chunk_v=0, name=None):
    """cross_entropy(hidden @ weight.T, label) as one streaming op that
    never forms the ``[N, V]`` logits (`ops.fused_loss`: kernels B4-B6
    on CUDA tensors). AMP white list: under bf16 auto_cast the hidden
    states and the table enter as bf16, and the table's gradient comes
    back to the f32 parameter through the cast's own backward."""
    hidden, weight = amp.cast("fused_linear_cross_entropy", hidden, weight)
    return fused_loss.fused_linear_cross_entropy(
        hidden, weight, label, ignore_index=ignore_index,
        reduction=reduction, chunk_v=chunk_v)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced loss with `axis` kept (size 1), and the softmax
    (without gradient) when asked."""
    logits, label = amp.cast("softmax_with_cross_entropy", logits, label)
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = _hard_labels(label, logits.dim(), axis)
        loss = -torch.gather(logp, axis, lbl.clamp_min(0).unsqueeze(axis))
        loss = loss * (lbl != ignore_index).unsqueeze(axis).to(loss.dtype)
    if return_softmax:
        return loss, torch.exp(logp).detach()
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label = amp.cast("bce_loss", input, label)
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = _mul(loss, weight)
    return _reduce_t(loss, reduction)


def _sigmoid_ce(logit, label, ignore_index=-100):
    """The reference's ``sigmoid_cross_entropy_with_logits``: labels at
    `ignore_index` contribute 0."""
    logit, label = amp.cast("sigmoid_cross_entropy_with_logits", logit,
                            label)
    loss = torch.clamp_min(logit, 0) - logit * label + torch.log1p(
        torch.exp(-logit.abs()))
    return loss * (label != ignore_index).to(loss.dtype)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    loss = _sigmoid_ce(logit, label)
    if pos_weight is not None:
        loss = _mul(loss, _add(_mul(_sub(pos_weight, 1.0), label), 1.0))
    if weight is not None:
        loss = _mul(loss, weight)
    return _reduce_t(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast("mse_loss", input, label)
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label):
    """Elementwise (input - label)^2, unreduced."""
    return mse_loss(input, label, reduction="none")


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over log_probs [T, B, C] (normalised again, as the reference's
    ``warpctc`` does). "mean" divides each sample's loss by its label
    length, then averages (paddle's mean, not torch's)."""
    lp = log_probs
    if lp.dim() == 3:
        lp = _t("transpose", lp).transpose(0, 1)
    (lp,) = amp.cast("warpctc", lp)
    loss = extra_ops.warpctc(lp, labels, input_lengths, label_lengths,
                             blank=blank, norm_by_times=norm_by_times)
    if reduction == "mean":
        return _mean(_div(loss, _t("cast", label_lengths).to(loss.dtype)))
    if reduction == "sum":
        return _sum(loss)
    return loss


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    anchor, positive = amp.cast("npair_loss", anchor, positive)
    return extra_ops.npair_loss(anchor, positive, labels, l2_reg=l2_reg)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = amp.cast("smooth_l1_loss", input, label)
    diff = (input - label).abs()
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log likelihood over dim 1 (AMP black list)."""
    input, weight = amp.cast("nll_loss", input, weight)
    lbl = label.long()
    loss = -torch.gather(input, 1, lbl.clamp_min(0).unsqueeze(1)).squeeze(1)
    valid = lbl != ignore_index
    loss = loss * valid.to(loss.dtype)
    w = None
    if weight is not None:
        w = weight[lbl.clamp_min(0)]
        loss = loss * w
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if w is not None:
        denom = torch.clamp_min((w * valid.to(loss.dtype)).sum(), 1e-12)
    else:
        denom = torch.clamp_min(valid.to(loss.dtype).sum(), 1.0)
    return loss.sum() / denom


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log label - input)`` (AMP black list); "batchmean"
    divides the sum by the batch size."""
    input, label = amp.cast("kldiv_loss", input, label)
    loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp.cast("margin_ranking_loss", input, other,
                                   label)
    loss = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = sigmoid(logit)
    ce = _sigmoid_ce(logit, label)
    p_t = _add(_mul(p, label), _mul(_sub(1, p), _sub(1, label)))
    alpha_t = _add(_mul(alpha, label), _mul(1 - alpha, _sub(1, label)))
    loss = _mul(_mul(alpha_t, amp.binary("elementwise_pow", _sub(1, p_t),
                                         gamma)), ce)
    if normalizer is not None:
        loss = _div(loss, normalizer)
    return _reduce_t(loss, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Per-sample [N, 1] hierarchical sigmoid losses, unreduced."""
    input, weight, bias = amp.cast("hierarchical_sigmoid", input, weight,
                                   bias)
    return extra_ops.hierarchical_sigmoid(
        input, weight, label, bias, path_table, path_code,
        num_classes=num_classes)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = amp.cast("cosine_similarity", x1, x2)
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """p-norm of ``x - y + epsilon`` over the last axis (epsilon added to
    the signed difference)."""
    d = _t("abs", _add(_sub(x, y), epsilon)).abs()
    if p == float("inf"):
        return _t("reduce_max", d).amax(dim=-1, keepdim=keepdim)
    if p == 0:
        return _sum(_t("cast", (d != 0)).to(d.dtype), dim=-1,
                    keepdim=keepdim)
    return amp.binary("elementwise_pow", _sum(
        amp.binary("elementwise_pow", d, p), dim=-1, keepdim=keepdim),
        1.0 / p)


# -- shape, resize, sampling -----------------------------------------------


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """paddle's pad: a full ``[lo, hi]`` per dim (2 * ndim entries), or
    pairs for the trailing spatial dims in `data_format` order, the
    first pair on the first spatial dim. Modes constant, reflect,
    replicate and circular."""
    if len(pad) == 2 * x.dim():
        paddings = [int(p) for p in pad]
    else:
        spatial = len(pad) // 2
        if data_format.startswith("NC"):
            paddings = [0, 0] * (x.dim() - spatial) + [int(p) for p in pad]
        else:
            paddings = [0, 0] + [int(p) for p in pad] + [0, 0]
    (x,) = amp.cast("pad", x)
    return nn_ops.pad(x, paddings=paddings, mode=mode, value=value)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """The reference's resize (``jax.image.resize`` arithmetic, see
    `ops.nn_ops.interpolate`); `align_corners` and `align_mode` are
    accepted and, as there, do not change the result."""
    if size is not None and not isinstance(size, (list, tuple)):
        size = [size, size]
    (x,) = amp.cast("interpolate", x)
    return nn_ops.interpolate(x, size=size, scale_factor=scale_factor,
                              mode=mode, data_format=data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = amp.cast("pixel_shuffle", x)
    return nn_ops.pixel_shuffle(x, upscale_factor=upscale_factor)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    (x,) = amp.cast("unfold", x)
    return nn_ops.unfold(x, kernel_sizes=kernel_sizes, strides=strides,
                         paddings=paddings, dilations=dilations)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    (x,) = amp.cast("temporal_shift", x)
    return nn_ops.temporal_shift(x, seg_num=seg_num,
                                 shift_ratio=shift_ratio)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    x, grid = amp.cast("grid_sampler", x, grid)
    return extra_ops.grid_sampler(x, grid, mode=mode,
                                  padding_mode=padding_mode,
                                  align_corners=align_corners)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    (theta,) = amp.cast("affine_grid", theta)
    return extra_ops.affine_grid(theta, out_shape=tuple(out_shape),
                                 align_corners=align_corners)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    (input,) = amp.cast("diag_embed", input)
    return torch.diag_embed(input, offset=offset, dim1=dim1, dim2=dim2)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon / K`` over the last axis (K its
    size); `prior_dist` is accepted and, as in the reference, unused."""
    return _add(_mul(1.0 - epsilon, label), epsilon / label.shape[-1])


# -- attention -------------------------------------------------------------


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None,
                                 qkv_layout="bshd"):
    """Attention over ``[batch, seq, heads, head_dim]`` inputs (or
    head-major ``[b, h, s, d]`` ones with ``qkv_layout="bhsd"``),
    returning ``[b, s, h, d]`` either way.

    Without a mask it is `ops.fused_ops.flash_attention` (kernels B1-B3
    on CUDA tensors), dropout in-kernel from one 32-bit seed per call.
    With an additive (float) or boolean mask it is the reference's plain
    op: f32 scores, causal mask aligned bottom-right, softmax, dropout of
    the probabilities from the installed generator (kept values divided
    by ``1 - p``). Inside a meshed engine's step both paths drop by the
    flash kernels' hash of the global batch-head, query and key under
    the site's seed (`framework.random.DropoutLayout.attention`)."""
    if qkv_layout == "bhsd":
        q, k, v = query, key, value
    else:
        q, k, v = (_t("transpose", t).transpose(1, 2)
                   for t in (query, key, value))
    use_dropout = dropout_p > 0.0 and training
    p = dropout_p if use_dropout else 0.0
    layout = _random.layout_for(q.device) if use_dropout else None
    if attn_mask is None:
        q, k, v = amp.cast("flash_attention", q, k, v)
        offset = None
        if layout is not None:
            seed, offset = layout.attention(q.shape[1])
        else:
            seed = _random.next_seed(q.device) if use_dropout else None
        out = fused_ops.flash_attention(q, k, v, seed, is_causal=is_causal,
                                        dropout_p=p, bh_offset=offset)
        return _t("transpose", out).transpose(1, 2)
    q, k, v, attn_mask = amp.cast("scaled_dot_product_attention", q, k, v,
                                  attn_mask)
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    s = s.float()
    if is_causal:
        s = fused_ops._causal_fill(s)
    if attn_mask.dtype == torch.bool:
        s = s.masked_fill(~attn_mask, NEG_INF)
    else:
        s = s + attn_mask
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    if use_dropout:
        # the reference's masked path divides by 1 - p in the
        # probabilities' dtype (its dropout op multiplies by 1 / (1 - p));
        # a tensor divisor keeps the division IEEE on CUDA
        # (`ops.quant_ops.true_div`)
        if layout is None:
            keep = _keep_mask(probs, p)
        else:
            b, h, sq, sk = probs.shape
            seed, offset = layout.attention(h)
            keep = fused_ops._keep_mask(seed, b * h, sq, sk, p, h,
                                        offset).reshape(probs.shape)
        probs = torch.where(
            keep, probs / torch.tensor(1.0 - p, dtype=probs.dtype,
                                       device=probs.device),
            torch.zeros((), dtype=probs.dtype, device=probs.device))
    return _t("transpose", torch.matmul(probs, v)).transpose(1, 2)
