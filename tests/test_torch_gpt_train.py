"""Port parity: GPT pretraining in paddle_tpu_torch against paddle_tpu on a
tiny GPT (vocab 128, hidden 32, 2 heads, 2 layers, seq 16, dropout 0)
with the same numpy weights (`torch_parity.build_pair`).

- `GPTPretrainingCriterion` with ``ignore_index`` and ``loss_mask``
  within rtol 1e-6 (f32 log-softmax in both);
- 3 AdamW steps through each package's ``Engine``: losses and every
  parameter within rtol 1e-5 / atol 1e-6, but for the key third of
  ``qkv_proj.bias``: a key bias shifts every score of a query by one
  constant, so its true gradient is 0 and both sides hold rounding
  noise, which Adam's normalised step turns into moves of up to the
  learning rate in either direction; it is held to 2 lr a step;
- ``recompute=True`` under ``FLAGS_remat_policy`` full, dots_saveable
  and none, against the reference under the same policy (same
  tolerance) and against the port without recompute (bit for bit: a
  recomputed segment runs the same ops on the same inputs);
- `engine.make_eval_step` against the reference's (logits within 1e-5,
  the training flag restored, no autograd graph);
- `Engine.memory_analysis` raises before the first step and, after it,
  on an engine that does not run on a card;
- `Engine.attribute_step` replays the last step under that step's own
  auto_cast policy, whatever the caller's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.engine import make_eval_step as j_make_eval_step
from paddle_tpu.engine import state_values
from paddle_tpu.framework import flags as jflags
from paddle_tpu.nlp.transformers.gpt import (
    GPTConfig as JConfig, GPTPretrainingCriterion as JCrit,
)

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.engine import make_eval_step as t_make_eval_step
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.nlp.transformers import gpt as tgpt
from torch_parity import build_pair

TINY_TRAIN = dict(vocab_size=128, hidden_size=32, num_heads=2,
                  num_layers=2, max_seq_len=16)
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3


def _batch(seed=0, n=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (n, 17))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.mark.parametrize("case", ["plain", "ignored", "ignore_index_5",
                                  "loss_mask"])
def test_criterion_matches_reference(case):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 16, 128).astype(np.float32) * 3
    labels = rng.randint(0, 128, (2, 16)).astype(np.int64)
    kw, mask = {}, None
    if case == "ignored":
        labels[rng.rand(2, 16) < 0.3] = -100
    if case == "ignore_index_5":
        kw = {"ignore_index": 5}
        labels[:, ::3] = 5
    if case == "loss_mask":
        mask = (rng.rand(2, 16) < 0.6).astype(np.float32)
    jcrit = JCrit(JConfig(**TINY_TRAIN, use_parallel=False), **kw)
    tcrit = tgpt.GPTPretrainingCriterion(
        tgpt.GPTConfig(**TINY_TRAIN, use_parallel=False), **kw)
    jargs = [paddle.to_tensor(logits), paddle.to_tensor(labels)]
    targs = [torch.from_numpy(logits), torch.from_numpy(labels)]
    if mask is not None:
        jargs.append(paddle.to_tensor(mask))
        targs.append(torch.from_numpy(mask))
    want = float(np.asarray(jcrit(*jargs)._value))
    got = float(tcrit(*targs))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_parallel_criterion_raises():
    """The criterion of GPTConfig's default ``use_parallel=True`` builds
    (ParallelCrossEntropy, degree 1 without a hybrid group) and gives the
    plain criterion's loss, ignored labels included; so does ERNIE's
    parallel criterion (ported since), over logits and NSP scores."""
    par = tgpt.GPTPretrainingCriterion(tgpt.GPTConfig(**TINY_TRAIN))
    plain = tgpt.GPTPretrainingCriterion(
        tgpt.GPTConfig(**dict(TINY_TRAIN, use_parallel=False)))
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 5, 128, generator=gen)
    labels = torch.randint(0, 128, (2, 5), generator=gen)
    labels[0, 1] = -100
    torch.testing.assert_close(par(logits, labels), plain(logits, labels),
                               rtol=0, atol=0)
    from paddle_tpu_torch.nlp.transformers import ernie as ternie
    epar, eplain = (ternie.ErniePretrainingCriterion(ternie.ErnieConfig(
        vocab_size=128, use_parallel=p)) for p in (True, False))
    nsp = torch.randn(2, 2, generator=gen)
    torch.testing.assert_close(epar(logits, nsp, labels),
                               eplain(logits, nsp, labels), rtol=1e-6,
                               atol=1e-6)


def _runs(policy=None, recompute=False, steps=3):
    """Losses and final parameters of `steps` AdamW steps of the tiny
    GPT in both packages (reference, port)."""
    jm, tm, _ = build_pair(seed=0, recompute=recompute, **TINY_TRAIN)
    jm.train()
    tm.train()
    cfg = tgpt.GPTConfig(**dict(TINY_TRAIN, use_parallel=False,
                                dropout=0.0, attn_dropout=0.0))
    jcrit = JCrit(JConfig(**dict(TINY_TRAIN, use_parallel=False)))
    jeng = JEngine(jm, paddle.optimizer.AdamW(
        LR, parameters=jm.parameters(), weight_decay=0.01), jcrit)
    teng = TEngine(tm, topt.AdamW(LR, parameters=tm.parameters(),
                                  weight_decay=0.01),
                   tgpt.GPTPretrainingCriterion(cfg), device="cpu", seed=0)
    prev = (jflags.get_flags("FLAGS_remat_policy"),
            tflags.get_flags("FLAGS_remat_policy"))
    if policy is not None:
        jflags.set_flags({"FLAGS_remat_policy": policy})
        tflags.set_flags({"FLAGS_remat_policy": policy})
    try:
        jl, tl = [], []
        ids, labels = _batch(0)
        for _ in range(steps):
            jl.append(float(np.asarray(
                jeng.train_batch(ids, labels)._value)))
            tl.append(float(teng.train_batch(ids, labels)))
    finally:
        jflags.set_flags(prev[0])
        tflags.set_flags(prev[1])
    jp = {k: np.asarray(v) for k, v in jeng.state.params.items()}
    tp = {k: p.detach().numpy().copy() for k, p in
          teng.state.params.items()}
    return (jl, jp), (tl, tp)


def _split_key_bias(name, a):
    """(the parameter without the key bias, the key bias or None)."""
    if not name.endswith("qkv_proj.bias"):
        return a, None
    h = a.shape[0] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


def _close(got, want, steps=3):
    (tl, tp), (jl, jp) = got, want
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert set(tp) == set(jp)
    for k in jp:
        (g, g_key), (w, w_key) = (_split_key_bias(k, a)
                                  for a in (tp[k], jp[k]))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
        if w_key is not None:
            assert np.abs(g_key - w_key).max() <= 2 * LR * steps * 1.01, k


def test_engine_steps_match_reference():
    ref, port = _runs()
    _close(port, ref)
    assert port[0][-1] < port[0][0]


@pytest.mark.parametrize("policy", ["full", "dots_saveable", "none"])
def test_recompute_policies_match_reference_and_plain(policy):
    ref, port = _runs(policy, recompute=True)
    _close(port, ref)
    _, plain = _runs()
    assert port[0] == plain[0]
    for k, v in plain[1].items():
        np.testing.assert_array_equal(port[1][k], v, err_msg=k)


def test_recompute_policy_flag_rejects_unknown():
    from paddle_tpu_torch.distributed.fleet.utils import remat_wrapper

    prev = tflags.get_flags("FLAGS_remat_policy")
    tflags.set_flags({"FLAGS_remat_policy": "bogus"})
    try:
        with pytest.raises(ValueError):
            remat_wrapper()
    finally:
        tflags.set_flags(prev)


def test_make_eval_step_matches_reference():
    jm, tm, _ = build_pair(seed=1, **TINY_TRAIN)
    jm.train()
    tm.train()
    ids, _ = _batch(5, n=2)
    want = np.asarray(j_make_eval_step(jm)(state_values(jm), ids))
    values = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    got = t_make_eval_step(tm)(values, torch.from_numpy(ids))
    assert tm.training and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_memory_analysis_raises_before_a_step_and_off_the_card():
    _, tm, _ = build_pair(seed=0, **TINY_TRAIN)
    cfg = tgpt.GPTConfig(**dict(TINY_TRAIN, use_parallel=False))
    eng = TEngine(tm, topt.AdamW(LR, parameters=tm.parameters()),
                  tgpt.GPTPretrainingCriterion(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.memory_analysis()
    eng.train_batch(*_batch())
    with pytest.raises(RuntimeError, match="card"):
        eng.memory_analysis()
    eng.sync_to_layer()


def test_attribute_step_replays_in_the_steps_precision(tmp_path):
    from paddle_tpu_torch import amp

    _, tm, _ = build_pair(seed=0, **TINY_TRAIN)
    cfg = tgpt.GPTConfig(**dict(TINY_TRAIN, use_parallel=False))
    crit = tgpt.GPTPretrainingCriterion(cfg)
    seen = []

    def loss_fn(*args):
        seen.append(amp.policy()[0] if amp.policy() else None)
        return crit(*args)

    eng = TEngine(tm, topt.AdamW(LR, parameters=tm.parameters()), loss_fn,
                  device="cpu")
    with amp.auto_cast(enable=True, dtype="bfloat16"):
        eng.train_batch(*_batch())
    eng.attribute_step(logdir=str(tmp_path / "a"))
    assert seen == [torch.bfloat16, torch.bfloat16]
    eng.train_batch(*_batch())
    eng.attribute_step(logdir=str(tmp_path / "b"))
    assert seen[2:] == [None, None]
