"""Port parity: nn.MultiHeadAttention through nn.Transformer against
paddle_tpu's, and a tiny Transformer built from public nn pieces in both
packages (2 + 2 layers, d_model 64, 4 heads, FFN 128, vocab 97, the
embedding shared by source, target and the output projection).

* Each Transformer class (tests/torch_nn_cases.py): state names, the
  outputs and the gradients of the inputs and of every parameter within
  rtol 1e-5 / atol 1e-6.
* The tiny model: logits with no mask, with a boolean source padding
  mask (True keeps), the float causal mask of
  ``generate_square_subsequent_mask`` and a memory mask, within rtol
  1e-4 / atol 1e-5 (f32: six attention blocks and the tied projection);
  a fully masked row averages its values as the reference's does (no
  NaN).
* Cached decoding through ``gen_cache`` / ``cache=``: each step's
  logits against the uncached forward over the same prefix, in the port
  and against the reference's cached decoding.
* One ``Engine`` step (Adam, label-smoothed soft-label cross entropy,
  dropout 0) in both packages: the loss and every parameter after the
  update within rtol 1e-4 / atol 1e-5 (the key projections' biases,
  whose gradient is zero but for rounding, moved by at most lr).
* ``copy.deepcopy`` stacks: every layer starts from the first one's
  weights; the state carries across the boundary by name.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.engine import state_values

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.engine import Engine as TEngine
from torch_nn_cases import L_CASES, layer_values
from torch_nn_parity import assert_same, check_layer_case, layer_pair, \
    to_np

VOCAB, D, HEADS, FFN, LAYERS = 97, 64, 4, 128, 2
RTOL, ATOL = 1e-4, 1e-5
_CLASSES = {"MultiHeadAttention", "TransformerEncoderLayer",
            "TransformerEncoder", "TransformerDecoderLayer",
            "TransformerDecoder", "Transformer"}


@pytest.mark.parametrize("case", [c for c in L_CASES if c.fn in _CLASSES],
                         ids=lambda c: c.id)
def test_transformer_layer_parity(case):
    check_layer_case(case)


def _positions(n, d=D):
    pos = np.arange(n)[:, None] / np.power(
        10000.0, 2 * (np.arange(d)[None, :] // 2) / d)
    return np.where(np.arange(d) % 2 == 0, np.sin(pos),
                    np.cos(pos)).astype(np.float32)


def _seq2seq(nn, to_tensor, matmul):
    """A Transformer translation model from public pieces: one shared
    embedding (scaled by sqrt(d) plus sinusoidal positions) and the
    output projection ``h @ emb.T``."""
    pos = to_tensor(_positions(64))

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(VOCAB, D)
            self.transformer = nn.Transformer(D, HEADS, LAYERS, LAYERS, FFN,
                                              dropout=0.0)

        def embed(self, ids, offset=0):
            return self.emb(ids) * math.sqrt(D) + \
                pos[offset:offset + ids.shape[1]]

        def logits(self, h):
            return matmul(h, self.emb.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                    memory_mask=None):
            return self.logits(self.transformer(
                self.embed(src), self.embed(tgt), src_mask, tgt_mask,
                memory_mask))

    return Seq2Seq()


def _pair(seed=0):
    jm = _seq2seq(jnn, paddle.to_tensor, paddle.matmul)
    tm = _seq2seq(tnn, torch.tensor, TF.matmul)
    shapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == shapes
    vals = layer_values(shapes, seed)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm.set_state_dict(vals)
    return jm, tm, vals


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, shape).astype(
        np.int64)


def _masks(kind, s_src, s_tgt):
    if kind == "none":
        return None, None, None
    keep = np.ones((2, 1, 1, s_src), bool)
    keep[1, ..., s_src - 3:] = False            # padding of sample 1
    causal = np.where(np.tril(np.ones((s_tgt, s_tgt))) > 0, 0.0,
                      -1e9).astype(np.float32)
    return keep, causal, keep


@pytest.mark.parametrize("masks", ["none", "masked"])
def test_tiny_transformer_forward(masks):
    jm, tm, _ = _pair()
    jm.eval()
    tm.eval()
    src, tgt = _ids((2, 9), 1), _ids((2, 7), 2)
    ms = _masks(masks, 9, 7)
    want = to_np(jm(paddle.to_tensor(src), paddle.to_tensor(tgt),
                    *(None if m is None else paddle.to_tensor(m)
                      for m in ms)))
    got = to_np(tm(torch.tensor(src), torch.tensor(tgt),
                   *(None if m is None else torch.tensor(m) for m in ms)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if masks == "masked":
        # the causal mask from the layer equals the hand-made one
        np.testing.assert_array_equal(
            tm.transformer.generate_square_subsequent_mask(7).numpy(),
            ms[1])


def test_fully_masked_rows_average_like_the_reference():
    jm, tm, _ = layer_pair(lambda nn: nn.MultiHeadAttention(64, 2),
                           train=False)
    q = np.random.default_rng(5).standard_normal((2, 3, 64)).astype(
        np.float32)
    keep = np.ones((2, 2, 3, 3), bool)
    keep[0, :, 1] = False                       # row 1 of sample 0: none
    want = to_np(jm(paddle.to_tensor(q), attn_mask=paddle.to_tensor(keep)))
    got = to_np(tm(torch.tensor(q), attn_mask=torch.tensor(keep)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _decode(model, to_tensor, src, steps, cat_ids):
    """Greedy decoding through gen_cache / cache=: (tokens [b, steps],
    per-step logits [steps, b, V])."""
    tr = model.transformer
    memory = tr.encoder(model.embed(src))
    cache = tr.decoder.gen_cache(memory)
    b = src.shape[0]
    ids = to_tensor(np.zeros((b, 1), np.int64))
    logits_all = []
    for t in range(steps):
        h, cache = tr.decoder(model.embed(ids[:, -1:], offset=t), memory,
                              cache=cache)
        logits = model.logits(h)[:, -1]
        logits_all.append(to_np(logits))
        nxt = np.argmax(logits_all[-1], axis=-1)[:, None].astype(np.int64)
        ids = cat_ids(ids, to_tensor(nxt))
    return to_np(ids)[:, 1:], np.stack(logits_all)


def _full_logits(model, to_tensor, src, prefix):
    """The uncached forward's last-position logits for each prefix."""
    out = []
    for t in range(prefix.shape[1]):
        ids = to_tensor(prefix[:, :t + 1])
        causal = np.where(np.tril(np.ones((t + 1, t + 1))) > 0, 0.0,
                          -1e9).astype(np.float32)
        out.append(to_np(model(to_tensor(src), ids,
                               tgt_mask=to_tensor(causal)))[:, -1])
    return np.stack(out)


def test_cached_decoding_matches_the_full_forward_and_the_reference():
    jm, tm, _ = _pair(seed=3)
    jm.eval()
    tm.eval()
    src = _ids((2, 8), 4)
    steps = 6
    with torch.no_grad():
        got_ids, got_logits = _decode(
            tm, torch.tensor, torch.tensor(src), steps,
            lambda a, b: torch.cat([a, b], dim=1))
    want_ids, want_logits = _decode(
        jm, paddle.to_tensor, paddle.to_tensor(src), steps,
        lambda a, b: paddle.concat([a, b], axis=1))
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_logits, want_logits, rtol=RTOL,
                               atol=ATOL)
    prefix = np.concatenate([np.zeros((2, 1), np.int64), got_ids[:, :-1]],
                            axis=1)
    with torch.no_grad():
        full = _full_logits(tm, torch.tensor, src, prefix)
    np.testing.assert_allclose(got_logits, full, rtol=RTOL, atol=ATOL)


def _smoothed_ce(F):
    def loss_fn(logits, tgt):
        soft = F.label_smooth(F.one_hot(tgt, VOCAB), epsilon=0.1)
        return F.cross_entropy(logits, soft, soft_label=True)

    return loss_fn


def test_one_engine_step_matches_the_reference():
    jm, tm, vals = _pair(seed=5)
    src, tgt = _ids((2, 9), 6), _ids((2, 8), 7)
    tgt_in, tgt_out = tgt[:, :-1], tgt[:, 1:]

    def fwd(model, mask_of):
        """forward(src, tgt_in) with the decoder's causal mask."""
        orig = model.forward

        def forward(src, tgt):
            return orig(src, tgt, tgt_mask=mask_of(tgt.shape[1]))

        model.forward = forward

    fwd(jm, lambda n: jm.transformer.generate_square_subsequent_mask(n))
    fwd(tm, lambda n: tm.transformer.generate_square_subsequent_mask(n))
    jo = jopt.Adam(1e-3, beta1=0.9, beta2=0.98, epsilon=1e-9,
                   parameters=jm.parameters())
    to = topt.Adam(1e-3, beta1=0.9, beta2=0.98, epsilon=1e-9,
                   parameters=tm.parameters())
    jeng = JEngine(jm, jo, _smoothed_ce(JF))
    teng = TEngine(tm, to, _smoothed_ce(TF), device="cpu")
    jl = float(np.asarray(jeng.train_batch((src, tgt_in), (tgt_out,))
                          ._value))
    tl = float(teng.train_batch((src, tgt_in), (tgt_out,)))
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    want = {k: np.asarray(v) for k, v in jeng.state.params.items()}
    got = {k: p.detach().numpy() for k, p in teng.state.params.items()}
    assert set(got) == set(want)
    for k in want:
        if k.endswith("k_proj.bias"):
            # zero gradient in exact arithmetic (softmax ignores a
            # per-query shift of the scores): Adam turns the rounding
            # noise into steps of at most lr, of either sign
            for v in (got[k], want[k]):
                assert np.abs(v - vals[k]).max() <= 1e-3 * 1.001, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(want[k], vals[k]), k


def test_stacks_start_from_the_first_layers_weights_and_cross_over():
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(64, 2, 96), 3)
    sd = enc.state_dict()
    for k in [k for k in sd if k.startswith("layers.0.")]:
        for i in (1, 2):
            assert torch.equal(sd[k], sd[k.replace("layers.0.",
                                                   f"layers.{i}.")])
    assert enc.layers[0].linear1.weight is not enc.layers[1].linear1.weight
    jm = jnn.Transformer(64, 2, 2, 2, 96)
    tm = tnn.Transformer(64, 2, 2, 2, 96)
    vals = {k: np.asarray(v) for k, v in state_values(jm).items()}
    weights.from_paddle_tpu_values(vals, tm)
    assert_same({k: to_np(v) for k, v in tm.state_dict().items()}, vals, 0,
                "transformer state", rtol=0)
