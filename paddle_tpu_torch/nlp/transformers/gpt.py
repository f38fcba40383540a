"""GPT model family (counterpart of paddle_tpu/nlp/transformers/gpt.py).

Single-device only in this slice: ``use_parallel=True`` (the tensor-
parallel Column/RowParallelLinear layout) raises until the distributed
slice lands. Parameter names and layouts equal
``paddle_tpu.engine.state_values`` one to one, so weights cross between
the packages as numpy arrays (see ``paddle_tpu_torch.weights``).

KV caches are updated IN PLACE (the reference returns new arrays): the
static-shape cache of `generate` via a slice assignment, the serving
engine's block-paged pools via an advanced-index scatter with numpy's
(and JAX's) semantics. Masks fill with -1e30 as the reference does.
"""

from __future__ import annotations

import torch

from ... import nn, resolve_device
from ...nn import functional as F

__all__ = ["GPTConfig", "gpt_config", "GPTModel", "GPTForPretraining",
           "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=None, max_seq_len=1024,
                 dropout=0.1, attn_dropout=0.1, layer_norm_eps=1e-5,
                 initializer_range=0.02, use_parallel=True,
                 sequence_parallel=False, tie_word_embeddings=True,
                 recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range
        self.use_parallel = use_parallel
        self.sequence_parallel = sequence_parallel
        self.tie_word_embeddings = tie_word_embeddings
        self.recompute = recompute


_PRESETS = {
    "gpt2-small": dict(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-medium": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": dict(hidden_size=1280, num_layers=36, num_heads=20),
    "gpt3-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                      max_seq_len=2048),
    "gpt3-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                      max_seq_len=2048),
}


def gpt_config(name, **overrides):
    cfg = dict(_PRESETS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


def _paged_rows(pos, tables, s_new, bs, num_blocks):
    """Physical scatter targets of a paged write: ``(blk, off, win)``
    flattened over ``[b, s_new]`` in row-major order. Rows past the
    table route to the null block 0 (``gpt.py:208-217`` of the
    reference). Several rows may hit the same (block, offset) — padding
    writes into the null block — and numpy/JAX scatter semantics let the
    LAST of them win; ``win[i]`` is the index of the write that wins at
    row i's target, so scattering ``values[win]`` makes every duplicate
    carry the same value and the result is deterministic on any device."""
    mb = tables.shape[1]
    s_max = mb * bs
    dev = pos.device
    t_idx = pos[:, None] + torch.arange(s_new, device=dev)   # [b, s_new]
    safe_t = torch.clamp(t_idx, max=s_max - 1)
    row = torch.arange(pos.shape[0], device=dev)[:, None]
    blk = torch.where(t_idx >= s_max, torch.zeros_like(t_idx),
                      tables[row, safe_t // bs]).reshape(-1)
    off = (safe_t % bs).reshape(-1)
    flat = blk * bs + off
    order = torch.arange(1, flat.numel() + 1, device=dev)
    last = torch.zeros(num_blocks * bs, dtype=order.dtype, device=dev)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    return t_idx, blk, off, last[flat] - 1


class GPTAttention(nn.Layer):
    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        h, nh = config.hidden_size, config.num_heads
        self.num_heads = nh
        self.head_dim = h // nh
        self.attn_dropout = config.attn_dropout
        init = nn.initializer.Normal(std=config.initializer_range)
        self.qkv_proj = nn.Linear(h, 3 * h, weight_attr=init,
                                  generator=generator)
        self.out_proj = nn.Linear(h, h, weight_attr=init,
                                  generator=generator)

    def forward(self, x, cache=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(
            b, s, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        if cache is not None:
            out, new_cache = self._attend_cached(q, k, v, cache)
            # [b, nh, s, hd] -> [b, s, nh*hd]
            out = out.transpose(1, 2).reshape(b, s, h)
            return self.out_proj(out), new_cache
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.attn_dropout if self.training else 0.0)
        return self.out_proj(out.reshape(b, s, h))

    def _attend_cached(self, q, k, v, cache):
        """Incremental decode attention over a static-shape KV cache.

        `cache` is ``(k_cache, v_cache, pos)`` with an int `pos` (the
        whole batch at one position — `generate`): the new keys/values
        land at ``[pos, pos + s_new)`` and queries attend to every cached
        position <= their own. Paged mode (the serving engine): `pos` is
        a tuple ``(pos_vec, block_tables)`` and the caches are physical
        block pools — see `_attend_paged`."""
        k_cache, v_cache, pos = cache
        if isinstance(pos, tuple):
            return self._attend_paged(q, k, v, k_cache, v_cache,
                                      pos[0], pos[1])
        s_new = q.shape[2]
        k_cache[:, :, pos:pos + s_new] = k.to(k_cache.dtype)
        v_cache[:, :, pos:pos + s_new] = v.to(v_cache.dtype)
        s_max = k_cache.shape[2]
        scale = 1.0 / (self.head_dim ** 0.5)
        scores = torch.matmul(q.float(),
                              k_cache.float().transpose(-1, -2)) * scale
        key_idx = torch.arange(s_max, device=q.device)
        q_pos = pos + torch.arange(s_new, device=q.device)
        mask = key_idx[None, :] <= q_pos[:, None]            # [s_new, s_max]
        scores = scores.masked_fill(~mask, F.NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out = torch.matmul(p, v_cache.float()).to(q.dtype)
        return out, (k_cache, v_cache, pos + s_new)

    def _attend_paged(self, q, k, v, k_pool, v_pool, pos, tables):
        """Paged decode attention: scatter the new KV through per-row
        block tables into the physical pools ``[num_blocks, nh, bs,
        hd]`` (in place), gather each row's logical ``[nh, s_max, hd]``
        view back, then the per-row causal mask ``key_idx <= t_idx``.
        Rows past a slot's allocation write into the reserved null block
        0 and stay unattended, since the mask only admits keys at or
        below each row's own position."""
        b, nh, s_new, hd = q.shape
        bs = k_pool.shape[2]
        s_max = tables.shape[1] * bs
        t_idx, blk, off, win = _paged_rows(pos, tables, s_new, bs,
                                           k_pool.shape[0])
        n = b * s_new
        k_pool[blk, :, off, :] = \
            k.transpose(1, 2).reshape(n, nh, hd)[win].to(k_pool.dtype)
        v_pool[blk, :, off, :] = \
            v.transpose(1, 2).reshape(n, nh, hd)[win].to(v_pool.dtype)
        k_view = k_pool[tables].permute(0, 2, 1, 3, 4).reshape(
            b, nh, s_max, hd)
        v_view = v_pool[tables].permute(0, 2, 1, 3, 4).reshape(
            b, nh, s_max, hd)
        scale = 1.0 / (self.head_dim ** 0.5)
        scores = torch.matmul(q.float(),
                              k_view.float().transpose(-1, -2)) * scale
        key_idx = torch.arange(s_max, device=q.device)
        mask = key_idx[None, None, :] <= t_idx[:, :, None]
        scores = scores.masked_fill(~mask[:, None], F.NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out = torch.matmul(p, v_view.float()).to(q.dtype)
        return out, (k_pool, v_pool, (pos + s_new, tables))


class GPTMLP(nn.Layer):
    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        h, f = config.hidden_size, config.ffn_hidden_size
        init = nn.initializer.Normal(std=config.initializer_range)
        self.fc1 = nn.Linear(h, f, weight_attr=init, generator=generator)
        self.fc2 = nn.Linear(f, h, weight_attr=init, generator=generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Layer):
    """Pre-LN decoder block."""

    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps)
        self.attn = GPTAttention(config, generator)
        self.norm2 = nn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps)
        self.mlp = GPTMLP(config, generator)
        self.dropout = config.dropout

    def forward(self, x, cache=None):
        if cache is not None:
            h, new_cache = self.attn(self.norm1(x), cache)
        else:
            h = self.attn(self.norm1(x))
        x = x + F.dropout(h, self.dropout, training=self.training)
        h = self.mlp(self.norm2(x))
        x = x + F.dropout(h, self.dropout, training=self.training)
        if cache is not None:
            return x, new_cache
        return x


class GPTEmbeddings(nn.Layer):
    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        init = nn.initializer.Normal(std=config.initializer_range)
        self.word_embeddings = nn.Embedding(
            config.vocab_size, config.hidden_size, weight_attr=init,
            generator=generator)
        self.position_embeddings = nn.Embedding(
            config.max_seq_len, config.hidden_size, weight_attr=init,
            generator=generator)
        self.dropout = config.dropout

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        return F.dropout(x, self.dropout, training=self.training)


class GPTModel(nn.Layer):
    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        if config.use_parallel:
            raise NotImplementedError(
                "use_parallel=True (tensor-parallel layers) is not ported "
                "yet; build the config with use_parallel=False")
        if config.recompute:
            raise NotImplementedError("recompute is not ported yet")
        self.config = config
        self.embeddings = GPTEmbeddings(config, generator)
        self.layers = nn.LayerList(
            [GPTDecoderLayer(config, generator)
             for _ in range(config.num_layers)])
        self.final_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)

    def forward(self, input_ids, position_ids=None, caches=None):
        x = self.embeddings(input_ids, position_ids)
        if caches is not None:
            new_caches = []
            for layer, c in zip(self.layers, caches):
                x, nc = layer(x, c)
                new_caches.append(nc)
            return self.final_norm(x), new_caches
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)

    def init_caches(self, batch_size, max_len, dtype=torch.bfloat16):
        """Zeroed static-shape KV caches for incremental decode (bf16 by
        default, as in the reference)."""
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_heads
        dev = self.final_norm.weight.device
        shape = (batch_size, cfg.num_heads, max_len, hd)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev), 0)
                for _ in range(cfg.num_layers)]


class GPTForPretraining(nn.Layer):
    """LM-head model; logits = h @ E^T (tied).

    Built on `device` (default cuda; raises when no GPU is visible).
    Weights are drawn on the CPU from `generator` (torch's default
    generator when None, which `paddle_tpu_torch.seed` seeds), so one
    seed gives the same weights on every device."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, generator)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias_attr=False, generator=generator)
        self.to(dev)

    @property
    def device(self):
        return self.gpt.final_norm.weight.device

    def forward(self, input_ids, position_ids=None):
        return self.logits(self.gpt(input_ids, position_ids))

    def logits(self, h):
        if self.config.tie_word_embeddings:
            w = self.gpt.embeddings.word_embeddings.weight
            return torch.matmul(h, w.t())
        return self.lm_head(h)

    @torch.no_grad()
    def generate(self, input_ids, *, max_new_tokens=20, do_sample=False,
                 top_k=50, temperature=1.0, eos_token_id=None, seed=0):
        """Autoregressive decoding with a static-shape bf16 KV cache: one
        prefill pass over the prompt, then one single-token step per new
        token. Returns ``[batch, prompt + max_new_tokens]`` int64 ids;
        positions after an eos repeat eos. Sampling draws from a
        `torch.Generator` seeded with `seed` (its numbers differ from
        the reference's jax.random ones; greedy decoding is identical)."""
        was_training = self.training
        self.eval()
        try:
            dev = self.device
            ids = torch.as_tensor(input_ids, device=dev).long()
            b, s0 = ids.shape
            max_len = s0 + max_new_tokens
            if max_len > self.config.max_seq_len:
                raise ValueError(
                    f"prompt + max_new_tokens = {max_len} exceeds "
                    f"max_seq_len {self.config.max_seq_len}")
            caches = self.gpt.init_caches(b, max_len)
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            done = torch.zeros((b,), dtype=torch.bool, device=dev)

            def step(tok_ids, pos_ids, caches):
                h, caches = self.gpt(tok_ids, pos_ids, caches)
                # only the last position feeds sampling
                return self.logits(h[:, -1]).float(), caches

            logits, caches = step(ids, torch.arange(s0, device=dev), caches)
            out = [ids]
            for t in range(max_new_tokens):
                if do_sample:
                    scaled = logits / max(temperature, 1e-6)
                    if top_k:
                        kth = torch.topk(
                            scaled, min(top_k, scaled.shape[-1]))[0]
                        scaled = torch.where(scaled < kth[:, -1:],
                                             float("-inf"), scaled)
                    nxt = torch.multinomial(torch.softmax(scaled, -1), 1,
                                            generator=gen)[:, 0]
                else:
                    nxt = torch.argmax(logits, dim=-1)
                if eos_token_id is not None:
                    nxt = torch.where(done, eos_token_id, nxt)
                    done = done | (nxt == eos_token_id)
                out.append(nxt[:, None])
                if t == max_new_tokens - 1:
                    break
                if eos_token_id is not None and bool(done.all()):
                    rest = max_new_tokens - t - 1
                    out.append(torch.full((b, rest), eos_token_id,
                                          dtype=ids.dtype, device=dev))
                    break
                pos = torch.tensor([s0 + t], device=dev)
                logits, caches = step(nxt[:, None], pos, caches)
            return torch.cat(out, dim=1)
        finally:
            if was_training:
                self.train()
