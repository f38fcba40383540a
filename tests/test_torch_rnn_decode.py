"""Port parity: the RNN family and seq2seq decoding against paddle_tpu.

* Each recurrent class of tests/torch_nn_cases.py (the three cells,
  `RNN`, `BiRNN`, 2-layer bidirectional `SimpleRNN` / `LSTM`, a
  time-major `GRU`): the same parameter names and shapes, outputs and
  final states, and the gradients of the inputs and of every parameter,
  within rtol 1e-5 / atol 1e-6.
* `LSTM` / `GRU` / `SimpleRNN` (relu) with given initial states, against
  the reference, forward and backward; their state crosses the boundary
  by name (``weights.from_paddle_tpu_values``).
* Inter-layer dropout acts in training only: in eval a dropout LSTM
  equals the same LSTM without dropout, in training two calls differ
  and the first layer's output is untouched.
* `gather_tree` against the reference; `BeamSearchDecoder` /
  `dynamic_decode` over a fixed-table cell against brute force (as
  tests/test_beam_search.py does for the reference) and against the
  reference's ids and scores.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.dispatch import apply as japply
from paddle_tpu.engine import state_values

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.ops import extra_ops
from torch_nn_cases import L_CASES
from torch_nn_parity import assert_same, check_layer_case, layer_pair, \
    run_port, run_ref, to_np

_CLASSES = {"SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
            "SimpleRNN", "LSTM", "GRU"}


@pytest.mark.parametrize("case", [c for c in L_CASES if c.fn in _CLASSES],
                         ids=lambda c: c.id)
def test_rnn_layer_parity(case):
    check_layer_case(case)


@pytest.mark.parametrize("cls,kw", [
    ("LSTM", dict(num_layers=2, direction="bidirect")),
    ("GRU", dict(num_layers=2, direction="bidirectional")),
    ("SimpleRNN", dict(num_layers=2, activation="relu"))])
def test_stacked_rnn_with_initial_states(cls, kw):
    jm, tm, vals = layer_pair(lambda nn: getattr(nn, cls)(6, 5, **kw))
    layers = kw["num_layers"] * (2 if "bidirect" in kw.get(
        "direction", "") else 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 6)).astype(np.float32)
    h0 = rng.standard_normal((layers, 3, 5)).astype(np.float32)
    c0 = rng.standard_normal((layers, 3, 5)).astype(np.float32)
    if cls == "LSTM":
        def call(m, x, h, c):
            return m(x, (h, c))
        arrays = [x, h0, c0]
    else:
        def call(m, x, h):
            return m(x, h)
        arrays = [x, h0]
    want, want_g = run_ref(call, arrays, True, jm)
    got, got_g = run_port(call, arrays, True, tm)
    assert_same(got, want, 1e-6, f"{cls} forward")
    assert_same(got_g, want_g, 1e-6, f"{cls} grad")
    # the reference's state loads into a fresh port layer by name
    fresh = getattr(tnn, cls)(6, 5, **kw)
    weights.from_paddle_tpu_values(
        {k: np.asarray(v) for k, v in state_values(jm).items()}, fresh)
    again, _ = run_port(call, arrays, False, fresh)
    assert_same(again, want, 1e-6, f"{cls} loaded")


def test_inter_layer_dropout_only_in_training():
    torch.manual_seed(0)
    m = tnn.LSTM(4, 6, num_layers=3, dropout=0.5)
    plain = tnn.LSTM(4, 6, num_layers=3)
    plain.set_state_dict(m.state_dict())
    x = torch.randn(2, 5, 4)
    m.eval()
    plain.eval()
    torch.testing.assert_close(m(x)[0], plain(x)[0], rtol=0, atol=0)
    m.train()
    a, b = m(x)[0], m(x)[0]
    assert not torch.equal(a, b)
    one = tnn.LSTM(4, 6, num_layers=1, dropout=0.5)
    one.set_state_dict({k: v for k, v in m.state_dict().items()
                        if k.endswith("_l0")})
    one.train()
    torch.testing.assert_close(one(x)[0], one(x)[0], rtol=0, atol=0)


def test_gather_tree_matches_the_reference():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 9, (5, 2, 3)).astype(np.int64)
    parents = rng.integers(0, 3, (5, 2, 3)).astype(np.int64)
    want = to_np(japply("gather_tree", paddle.to_tensor(ids),
                        paddle.to_tensor(parents)))
    got = extra_ops.gather_tree(torch.tensor(ids), torch.tensor(parents))
    np.testing.assert_array_equal(got.numpy(), want)


VOCAB, END = 5, 0


def _cell(nn, to_tensor):
    class FixedCell(nn.Layer):
        """Logits depend only on the previous token (a Markov chain)."""

        def __init__(self, table):
            super().__init__()
            self._table = to_tensor(table)

        def forward(self, tokens, states):
            return self._table[tokens], states

    return FixedCell


def _path_score(table, start, path):
    score, prev = 0.0, start
    for tok in path:
        row = table[prev].astype(np.float64)
        score += row[tok] - np.log(np.exp(row).sum())
        prev = tok
    return score


def _brute_force(table, start, length):
    best, best_score = None, -np.inf
    for path in itertools.product(range(VOCAB), repeat=length):
        if END in path:
            continue
        score = _path_score(table, start, path)
        if score > best_score:
            best, best_score = list(path), score
    return best, best_score


@pytest.mark.parametrize("beam,seed", [(4, 0), (3, 1), (1, 2)])
def test_beam_search_against_brute_force_and_the_reference(beam, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((VOCAB, VOCAB)).astype(np.float32) * 2.0
    table[:, END] = -5.0
    steps = 4
    tcell = _cell(tnn, torch.tensor)(table)
    ids, scores = tnn.dynamic_decode(
        tnn.BeamSearchDecoder(tcell, 1, END, beam), torch.zeros(2, 1),
        max_step_num=steps)
    assert tuple(ids.shape) == (2, steps, beam)
    jcell = _cell(jnn, paddle.to_tensor)(table)
    jids, jscores = jnn.dynamic_decode(
        jnn.BeamSearchDecoder(jcell, 1, END, beam), paddle.zeros([2, 1]),
        max_step_num=steps)
    # the same scores, each the exact score of its beam's path (a Markov
    # table ties the paths that reorder the same transitions exactly, so
    # which of two tied paths fills the last beam is rounding's choice)
    np.testing.assert_allclose(scores.numpy(), to_np(jscores), rtol=1e-5,
                               atol=1e-6)
    for b in range(2):
        for w in range(beam):
            np.testing.assert_allclose(
                _path_score(table, 1, ids[b, :, w].tolist()),
                float(scores[b, w]), rtol=1e-5)
    if beam > 1:
        want, want_score = _brute_force(table, 1, steps)
        assert ids[0, :, 0].tolist() == want
        np.testing.assert_allclose(float(scores[0, 0]), want_score,
                                   rtol=1e-5)


def test_finished_beams_extend_with_the_end_token():
    table = np.full((VOCAB, VOCAB), -10.0, np.float32)
    table[1, END] = 5.0
    table[END, 2] = 5.0
    cell = _cell(tnn, torch.tensor)(table)
    ids, _ = tnn.dynamic_decode(tnn.BeamSearchDecoder(cell, 1, END, 2),
                                torch.zeros(1, 1), max_step_num=4)
    assert bool((ids[0, :, 0] == END).all())
    tiled = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.arange(6).reshape(2, 3), 2)
    assert tiled[:, 0].tolist() == [0, 0, 3, 3]
