"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
one tiny GPT, one tiny ERNIE and a 2-layer MLP built in both packages
with the same numpy weights, and a synchronous helper that runs an
engine to completion.

Weights are drawn with numpy from a fixed seed at a larger scale than
the models' own 0.02 init (which makes a tiny random GPT repeat one
token), and LayerNorm/bias leaves get random values too, so the
comparisons exercise every parameter.
"""

from __future__ import annotations

import numpy as np

VOCAB = 97
# the config of tests/test_serving_w8a8.py
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0, attn_dropout=0.0,
            use_parallel=False)


def random_values(names_shapes, seed=0):
    """{name: f32 array}: N(0, 0.1) matrices, LayerNorm weights near 1,
    small random biases."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        if len(shape) >= 2:
            v = rng.randn(*shape) * 0.1
        elif "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        out[name] = v.astype(np.float32)
    return out


def build_pair(seed=0, **overrides):
    """(jax model, torch model, numpy values) of the tiny GPT with the
    same random weights in both packages (torch model on the CPU)."""
    import paddle_tpu as paddle
    from paddle_tpu.engine import state_values
    from paddle_tpu.nlp.transformers import GPTConfig, GPTForPretraining

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt

    cfg = dict(TINY, **overrides)
    jm = GPTForPretraining(GPTConfig(**cfg))
    jm.eval()
    shapes = [(k, tuple(v.shape)) for k, v in state_values(jm).items()]
    vals = random_values(shapes, seed)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    return jm, tm, vals


# a tiny ERNIE: every module of the full-width one at narrow widths
ERNIE_TINY = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                  num_heads=4, ffn_hidden_size=128, max_seq_len=32,
                  dropout=0.0, attn_dropout=0.0, use_parallel=False)


def build_ernie_pair(seed=0, **overrides):
    """(jax model, torch model, numpy values) of the tiny ERNIE with the
    same random weights in both packages (torch model on the CPU)."""
    import paddle_tpu as paddle
    from paddle_tpu.engine import state_values
    from paddle_tpu.nlp.transformers import ErnieConfig, ErnieForPretraining

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import ernie as ternie

    cfg = dict(ERNIE_TINY, **overrides)
    jm = ErnieForPretraining(ErnieConfig(**cfg))
    shapes = [(k, tuple(v.shape)) for k, v in state_values(jm).items()]
    vals = random_values(shapes, seed)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**cfg), device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    return jm, tm, vals


def prompt(seed, n):
    return np.random.RandomState(seed).randint(
        1, VOCAB, (n,)).astype(np.int32)


def drive(eng, prompts, max_new=8, gens=None):
    """Submit every prompt, then admit + step synchronously until all
    finish (the engine's `_loop` without its thread). Returns the
    result id arrays in submission order."""
    gens = gens or [{}] * len(prompts)
    futs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                       timeout=None, **g)
            for p, g in zip(prompts, gens)]
    while True:
        eng._admit()
        if not eng.active:
            break
        eng._step()
    return [np.asarray(f.result(10)) for f in futs]


# a 2-layer MLP (8 -> 16 -> 4) for the optimizer, clipping and io tests


def _mlp_classes():
    import torch

    import paddle_tpu as paddle

    from paddle_tpu_torch import nn as tnn

    class JMLP(paddle.nn.Layer):
        def __init__(self, attrs=None):
            super().__init__()
            attrs = attrs or {}
            self.fc1 = paddle.nn.Linear(8, 16, weight_attr=attrs.get("w1"))
            self.fc2 = paddle.nn.Linear(16, 4, bias_attr=attrs.get("b2"))

        def forward(self, x):
            return self.fc2(paddle.nn.functional.relu(self.fc1(x)))

    class TMLP(tnn.Layer):
        def __init__(self, attrs=None):
            super().__init__()
            attrs = attrs or {}
            self.fc1 = tnn.Linear(8, 16, weight_attr=attrs.get("w1"))
            self.fc2 = tnn.Linear(16, 4, bias_attr=attrs.get("b2"))

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    return JMLP, TMLP


def mlp_values(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1.weight": rng.randn(8, 16).astype(np.float32) * 0.5,
            "fc1.bias": rng.randn(16).astype(np.float32) * 0.1,
            "fc2.weight": rng.randn(16, 4).astype(np.float32) * 0.5,
            "fc2.bias": rng.randn(4).astype(np.float32) * 0.1}


def mlp_batches(n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(6, 8).astype(np.float32),
             rng.randn(6, 4).astype(np.float32)) for _ in range(n)]


def mlp_pair(jattrs=None, tattrs=None, seed=0):
    """(reference MLP, port MLP) with the same weights and the same
    automatic parameter names (both packages' name counters are reset
    first). `jattrs` / `tattrs`: ``{"w1": fc1's weight_attr, "b2":
    fc2's bias_attr}``."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.layer import layers as jlayers

    from paddle_tpu_torch.nn.layer import layers as tlayers

    JMLP, TMLP = _mlp_classes()
    jlayers._auto_name_counters.clear()
    tlayers._auto_name_counters.clear()
    jm, tm = JMLP(jattrs), TMLP(tattrs)
    vals = mlp_values(seed)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm.set_state_dict(vals)
    assert [p.name for p in jm.parameters()] == \
        [p.name for p in tm.parameters()]
    return jm, tm


def mlp_mse(out, y):
    return ((out - y) * (out - y)).mean()
