"""Functional ops the GPT slice uses (ref paddle_tpu/nn/functional)."""

from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["linear", "gelu", "dropout", "layer_norm",
           "scaled_dot_product_attention"]

# additive mask value of the reference's attention paths (a large finite
# negative, not -inf, so a fully masked row cannot turn into NaN)
NEG_INF = -1e30


def linear(x, weight, bias=None):
    """y = x @ W + b with W in paddle's [in, out] layout."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def gelu(x, approximate=False):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout; identity in eval or at p == 0."""
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return tF.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def scaled_dot_product_attention(q, k, v, is_causal=False, dropout_p=0.0):
    """Plain attention over head-major ``[b, h, s, d]`` inputs, returning
    ``[b, s, h, d]`` like the reference's ``qkv_layout='bhsd'`` mode.

    Stand-in for the flash-attention kernel (paddle_tpu
    ``ops/fused_ops.py::_fwd_kernel``, still to be ported): this is the
    reference's jnp path (``_flash_fwd_jnp``) in PyTorch — f32 scores,
    bottom-right aligned causal mask ``q_idx + (sk - sq) >= k_idx`` with
    a -1e30 fill, softmax in f32. Dropout is not supported here."""
    if dropout_p:
        raise NotImplementedError(
            "attention dropout needs the flash-attention kernel, which "
            "is not ported yet")
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        sq, sk = s.shape[-2], s.shape[-1]
        q_idx = torch.arange(sq, device=s.device)[:, None]
        k_idx = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(q_idx + (sk - sq) < k_idx, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.float()).to(q.dtype)
    return out.transpose(1, 2)
