"""Transformer layers (ref paddle_tpu/nn/layer/transformer.py):
`MultiHeadAttention` through the Transformer.

Attention goes through `functional.scaled_dot_product_attention` on
``[b, s, heads, head_dim]`` tensors: without a mask that is
`ops.fused_ops.flash_attention` (kernels B1-B3 on CUDA tensors), with a
mask the plain masked path. A boolean mask (True keeps) becomes the
additive float mask ``where(mask, 0, -1e9)``, so a fully masked row
averages its values instead of turning into NaN. Caches are
``MultiHeadAttention.Cache`` (the keys and values so far, grown by
concatenation each step) and ``StaticCache`` (the projected memory of a
cross-attention, computed once). Stacks are built from one layer and
``copy.deepcopy`` copies of it, so every layer starts from the first
one's weights, as in the reference.
"""

from __future__ import annotations

import collections
import copy

import torch

from ... import amp
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attn_mask(mask):
    """A bool mask (True keeps) as the additive float32 mask; a float
    mask as it is."""
    if mask is None or mask.dtype != torch.bool:
        return mask
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1e9))


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        g = generator
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             generator=g)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             generator=g)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             generator=g)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               generator=g)

    def _heads(self, x):
        (x,) = amp.cast("reshape", x)
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat(amp.cast("concat", cache.k, k), dim=1)
            v = torch.cat(amp.cast("concat", cache.v, v), dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask),
            dropout_p=self.dropout if self.training else 0.0)
        (out,) = amp.cast("reshape", out)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def gen_cache(self, key, value=None, type=Cache):
        """A `StaticCache` of the projected `key` / `value`, or an empty
        `Cache` ([b, 0, heads, head_dim]) to grow step by step."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value if value is not None
                                        else key))
            return self.StaticCache(k, v)
        empty = torch.zeros((key.shape[0], 0, self.num_heads,
                             self.head_dim), dtype=key.dtype,
                            device=key.device)
        return self.Cache(empty, empty.clone())


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        g = generator
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=g)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, generator=g)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, generator=g)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = amp.binary("elementwise_add", residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = amp.binary("elementwise_add", residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, new_cache = layer(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        g = generator
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=g)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=g)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, generator=g)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, generator=g)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            new_self_cache = None
        else:
            tgt, new_self_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                 cache[0])
        tgt = amp.binary("elementwise_add", residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None or cache[1] is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = cache[1] if cache is not None else None
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = amp.binary("elementwise_add", residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = amp.binary("elementwise_add", residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_self_cache, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = layer(output, memory, tgt_mask,
                                          memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    """Encoder-decoder at the reference's defaults: d_model 512, 8
    heads, 6 + 6 layers, FFN 2048, dropout 0.1, ReLU, post-LN (a final
    LayerNorm on each stack only with ``normalize_before``)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, generator=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            encoder_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, generator=generator)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(encoder_layer,
                                              num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            decoder_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, generator=generator)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(decoder_layer,
                                              num_decoder_layers, norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length, device=None):
        """The float causal mask [length, length]: 0 on and below the
        diagonal, -1e9 above; on the layer's device unless given."""
        if device is None:
            device = next(self.parameters()).device
        keep = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                     device=device))
        return _convert_attn_mask(keep)
