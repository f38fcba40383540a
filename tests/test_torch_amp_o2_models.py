"""Port parity: auto_cast level O2 against paddle_tpu's dispatch rewrite
over a whole forward of each driven model: a 2-layer GPT and ERNIE (its
encoder and pooler), the nn.Transformer of test_torch_transformer.py, a
narrow bottleneck ResNet in eval and training mode. The output dtypes,
and how many times each op name casts (a residual add the port left as
a torch operator would be one ``elementwise_add`` short), are the
reference's. The outputs agree within 2^-4 of the largest output in
bf16 and 2^-7 in f16 (each package rounds every intermediate to the low
dtype; the roundings fall in different places inside fused ops).
ResNet's training forward is compared by names and dtypes only: its
last stage normalises 2 values a channel, so an ulp moves it by its
whole range.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp

from paddle_tpu_torch import amp as tamp
from test_torch_amp_o2 import DTYPES, recorded  # noqa: F401
from torch_nn_parity import flat

# a model's outputs against the reference's, relative to the largest
MODEL_TOL = {"bfloat16": 2.0 ** -4, "float16": 2.0 ** -7}


def _gpt():
    from torch_parity import build_pair

    jm, tm, _ = build_pair()
    return jm, tm


def _ernie():
    from torch_parity import build_ernie_pair

    jm, tm, _ = build_ernie_pair()
    # the encoder and pooler (the heads return the fused loss's handle)
    return jm.ernie, tm.ernie


def _ids(seed=0):
    from torch_parity import VOCAB

    return np.random.RandomState(seed).randint(1, VOCAB, (2, 16)).astype(
        np.int64)


def _lm_inputs():
    ids = _ids()
    return (paddle.to_tensor(ids),), (torch.tensor(ids),)


def _transformer():
    import test_torch_transformer as tt

    jm, tm, _ = tt._pair()
    return jm.transformer, tm.transformer


def _transformer_inputs():
    from test_torch_transformer import D

    rng = np.random.RandomState(5)
    src = rng.randn(2, 9, D).astype(np.float32)
    tgt = rng.randn(2, 7, D).astype(np.float32)
    return (paddle.to_tensor(src), paddle.to_tensor(tgt)), \
        (torch.tensor(src), torch.tensor(tgt))


def _resnet():
    import test_torch_resnet as tr

    make_j, make_t = tr.MODELS["bottleneck16"]
    jm, tm, _ = tr._pair(lambda: make_j(True), lambda: make_t(True))
    return jm, tm


def _image_inputs():
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    return (paddle.to_tensor(x),), (torch.tensor(x),)


MODELS = {"gpt": (_gpt, _lm_inputs, "eval"),
          "ernie": (_ernie, _lm_inputs, "eval"),
          "transformer": (_transformer, _transformer_inputs, "eval"),
          "resnet_eval": (_resnet, _image_inputs, "eval"),
          "resnet_train": (_resnet, _image_inputs, "train")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_o2_matches_reference_casts(name, dtype, recorded):
    ref, port = recorded
    build, inputs, mode = MODELS[name]
    jm, tm = build()
    getattr(jm, mode)()
    getattr(tm, mode)()
    jin, tin = inputs()
    ref.clear()
    port.clear()
    with jamp.auto_cast(enable=True, level="O2", dtype=dtype):
        want = flat(jm(*jin))
    with tamp.auto_cast(enable=True, level="O2", dtype=dtype):
        got = flat(tm(*tin))
    assert [str(o.dtype).replace("torch.", "") for o in got] == \
        [str(o._value.dtype) for o in want]
    assert collections.Counter(port) == collections.Counter(ref), (
        collections.Counter(port) - collections.Counter(ref),
        collections.Counter(ref) - collections.Counter(port))
    if mode == "eval":
        for g, w in zip(got, want):
            w = np.asarray(w._value.astype("float32"))
            np.testing.assert_allclose(
                g.detach().float().numpy(), w, rtol=0,
                atol=MODEL_TOL[dtype] * float(np.abs(w).max()))
