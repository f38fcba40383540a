"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
one tiny GPT built in both packages with the same numpy weights, and a
synchronous helper that runs an engine to completion.

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
