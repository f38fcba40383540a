"""Port parity: paddle_tpu_torch's ERNIE pretraining step against
paddle_tpu's, on a tiny config (vocab 97, hidden 64, 2 layers, 4 heads,
FFN 128, seq 32, batch 2) with the same numpy weights in both packages
(`torch_parity.build_ernie_pair`) and ``FLAGS_use_fused_lm_loss`` off on
both sides. Dropout is 0: the two packages draw different random bits.

- eval logits and NSP scores within rtol 1e-5, atol 5e-5 (f32 sums in
  other orders, magnified where a LayerNorm with eps 1e-12 divides by a
  row's small spread: one run of the flash case in about ten has shown
  1.6e-5 at a logit near 0.06), the criterion loss within 1e-5,
  without a mask (flash attention) and with a padding mask (the masked
  attention op);
- 3 `Engine.train_batch` steps of AdamW (decay skipped on biases and
  norms by ``apply_decay_param_fun``, global-norm clipping that bites):
  losses within rtol 1e-4, final parameters within rtol 1e-4 and atol
  1e-5 (1% of one step: Adam's normalised step m/sqrt(v) magnifies
  the gradients' rounding where a gradient changes sign between steps);
- the same under bf16 ``auto_cast``: losses within 2e-2 relative, and
  each parameter's total update within 10% of the reference's in L2
  norm (bf16 products round at other places in the two frameworks, and
  Adam turns a gradient near 0 whose sign differs into a full step of
  the other sign: elementwise bounds do not hold);
- a port engine resumed from the reference's parameters and AdamW state
  after step 2 (``weights.from_paddle_tpu_opt_state``) continues the
  reference's trajectory within the f32 tolerances;
- with ``FLAGS_use_fused_lm_loss`` on (the default) on both sides: the
  head returns a ``DeferredLMHead`` in both packages, the eval loss
  agrees within 1e-5 and the 3-step f32 and bf16 trajectories within
  the tolerances above; the port's fused and unfused trajectories agree
  within the f32 ones;
- ``recompute=True``: with dropout 0.1 the port's losses, gradients and
  parameters equal those without recompute bit for bit (the replay
  restores the engine's dropout streams), and with dropout 0 its
  trajectory follows the reference's ``recompute=True`` one;
- ``ErnieForSequenceClassification`` logits within the eval tolerance.

The key third of each ``qkv_proj.bias`` is held only to the most that
two Adam trajectories can part, 2 lr a step: its gradient is zero up to
rounding (a key bias shifts every score of a query by one constant,
which softmax ignores), so both frameworks move it by full steps in the
directions of their own rounding noise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.engine import Engine as JEngine
from paddle_tpu.framework import flags as jflags
from paddle_tpu.nlp.transformers import ErniePretrainingCriterion as JCrit
from paddle_tpu.ops.fused_loss import DeferredLMHead as JDeferred

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.clip import ClipGradByGlobalNorm as TClip
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nlp.transformers import ernie as ternie
from torch_parity import ERNIE_TINY, VOCAB, build_ernie_pair, random_values

FLAG = "FLAGS_use_fused_lm_loss"
LR, STEPS, RESUME_AT = 1e-3, 3, 2
PARAM_ATOL = 1e-2 * LR


def _no_decay(name):
    # reads the same on the reference's auto names ("linear_3.bias",
    # "layernorm_0.weight") and the port's structured ones
    return not (name.endswith("bias") or "norm" in name)


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    types = rng.randint(0, 2, (b, s)).astype(np.int32)
    mlm = ids.copy()
    mlm[rng.rand(b, s) > 0.3] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return (ids, types), (mlm, nsp)


@pytest.fixture(scope="module")
def unfused():
    prev = (jflags.get_flags(FLAG)[FLAG], tflags.get_flags(FLAG)[FLAG])
    jflags.set_flags({FLAG: False})
    tflags.set_flags({FLAG: False})
    yield
    jflags.set_flags({FLAG: prev[0]})
    tflags.set_flags({FLAG: prev[1]})


@pytest.fixture
def fused():
    """FLAGS_use_fused_lm_loss on (its default) on both sides for one
    test, whatever the module fixture set."""
    prev = (jflags.get_flags(FLAG)[FLAG], tflags.get_flags(FLAG)[FLAG])
    jflags.set_flags({FLAG: True})
    tflags.set_flags({FLAG: True})
    yield
    jflags.set_flags({FLAG: prev[0]})
    tflags.set_flags({FLAG: prev[1]})


def _split_key_bias(name, a):
    """(the parameter without the key bias, the key bias or None)."""
    if not name.endswith("qkv_proj.bias"):
        return a, None
    h = a.shape[0] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


def _assert_params_close(got, want, steps):
    assert set(got) == set(want)
    for k, v in want.items():
        (g, g_key), (w, w_key) = (_split_key_bias(k, a) for a in (got[k], v))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=PARAM_ATOL,
                                   err_msg=k)
        if w_key is not None:
            assert np.abs(g_key - w_key).max() <= 2 * LR * steps * 1.01, k


def _jax_run(amp_on, steps, **cfg):
    """Losses of `steps` reference steps, the parameters and AdamW state
    after step RESUME_AT, and the final parameters (numpy)."""
    jm, _, vals = build_ernie_pair(seed=0, **cfg)
    crit = JCrit()
    opt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters(), weight_decay=0.01,
        apply_decay_param_fun=_no_decay)
    eng = JEngine(jm, opt, lambda out, mlm, nsp: crit(out[0], out[1], mlm,
                                                      nsp),
                  grad_clip=JClip(1.0))
    inputs, labels = _batch()
    losses, mid = [], None
    for i in range(steps):
        with jamp.auto_cast(enable=amp_on, dtype="bfloat16"):
            losses.append(float(np.asarray(
                eng.train_batch(inputs, labels)._value)))
        if i + 1 == RESUME_AT:
            mid = ({k: np.array(v) for k, v in eng.state.params.items()},
                   {k: {n: np.array(a) for n, a in st.items()}
                    for k, st in eng.state.opt_state.items()})
    final = {k: np.array(v) for k, v in eng.state.params.items()}
    return vals, losses, mid, final


def _torch_engine(vals, seed=None, **cfg):
    tm = ternie.ErnieForPretraining(
        ternie.ErnieConfig(**dict(ERNIE_TINY, **cfg)), device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    crit = ternie.ErniePretrainingCriterion()
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters(),
                     weight_decay=0.01, apply_decay_param_fun=_no_decay)
    return TEngine(tm, opt, lambda out, mlm, nsp: crit(out[0], out[1], mlm,
                                                       nsp),
                   grad_clip=TClip(1.0), device="cpu", seed=seed)


def _torch_run(eng, amp_on, steps):
    inputs, labels = _batch()
    losses = []
    for _ in range(steps):
        with tamp.auto_cast(enable=amp_on, dtype="bfloat16"):
            losses.append(float(eng.train_batch(inputs, labels)))
    return losses, {k: p.detach().numpy().copy()
                    for k, p in eng.state.params.items()}


@pytest.fixture(scope="module")
def f32_run(unfused):
    return _jax_run(False, RESUME_AT + 1)


@pytest.mark.parametrize("padded", [False, True],
                         ids=["flash", "padding_mask"])
def test_eval_logits_nsp_and_loss_match(unfused, padded):
    jm, tm, _ = build_ernie_pair(seed=1)
    jm.eval()
    tm.eval()
    (ids, types), (mlm, nsp) = _batch(seed=4)
    # a [b, s] padding mask takes the masked attention path
    mask = np.ones_like(ids)
    mask[1, -7:] = 0
    jmask, tmask = (paddle.to_tensor(mask), torch.from_numpy(mask)) \
        if padded else (None, None)
    jl, jn = jm(paddle.to_tensor(ids), paddle.to_tensor(types), None, jmask)
    jloss = JCrit()(jl, jn, paddle.to_tensor(mlm), paddle.to_tensor(nsp))
    with torch.no_grad():
        tl, tn = tm(torch.from_numpy(ids).long(),
                    torch.from_numpy(types).long(), None, tmask)
        tloss = ternie.ErniePretrainingCriterion()(
            tl, tn, torch.from_numpy(mlm).long(),
            torch.from_numpy(nsp).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                               rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn._value),
                               rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(float(tloss), float(np.asarray(jloss._value)),
                               rtol=1e-5, atol=1e-5)


def test_f32_adamw_trajectory_matches(f32_run):
    vals, jlosses, _, jfinal = f32_run
    tlosses, tfinal = _torch_run(_torch_engine(vals), False, RESUME_AT + 1)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=1e-6)
    assert tlosses[-1] < tlosses[0]
    _assert_params_close(tfinal, jfinal, RESUME_AT + 1)


def test_f32_trajectory_resumed_from_reference_state(f32_run):
    _, jlosses, (params, opt_state), jfinal = f32_run
    eng = _torch_engine(params)
    weights.from_paddle_tpu_opt_state(opt_state, eng)
    assert float(eng.state.opt_state["cls.transform.weight"][
        "beta1_pow"]) == pytest.approx(0.9 ** RESUME_AT)
    tlosses, tfinal = _torch_run(eng, False, 1)
    np.testing.assert_allclose(tlosses, jlosses[RESUME_AT:], rtol=1e-4,
                               atol=1e-6)
    _assert_params_close(tfinal, jfinal, 1)


def test_bf16_auto_cast_trajectory_matches(unfused):
    vals, jlosses, _, jfinal = _jax_run(True, STEPS)
    tlosses, tfinal = _torch_run(_torch_engine(vals), True, STEPS)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-2)
    for k, v in jfinal.items():
        (g, g_key), (w, w_key), (v0, _) = (
            _split_key_bias(k, a) for a in (tfinal[k], v, vals[k]))
        moved = np.linalg.norm(w - v0)
        assert np.linalg.norm((g - v0) - (w - v0)) <= 0.1 * moved, k
        if w_key is not None:
            assert np.abs(g_key - w_key).max() <= 2 * LR * STEPS * 1.01, k


def test_fused_head_returns_the_handle_in_both_packages(fused):
    jm, tm, _ = build_ernie_pair(seed=2)
    jm.eval()
    tm.eval()
    (ids, types), _ = _batch(seed=5)
    jl, _ = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids).long(),
                   torch.from_numpy(types).long())
    assert isinstance(jl, JDeferred)
    assert isinstance(tl, ternie.DeferredLMHead)
    assert tl.weight is tm.ernie.embeddings.word_embeddings.weight
    np.testing.assert_allclose(tl.materialize().detach().numpy(),
                               np.asarray(jl.materialize()._value),
                               rtol=1e-5, atol=5e-5)


def test_fused_eval_loss_matches(fused):
    jm, tm, _ = build_ernie_pair(seed=1)
    jm.eval()
    tm.eval()
    (ids, types), (mlm, nsp) = _batch(seed=4)
    jl, jn = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    jloss = JCrit()(jl, jn, paddle.to_tensor(mlm), paddle.to_tensor(nsp))
    with torch.no_grad():
        tl, tn = tm(torch.from_numpy(ids).long(),
                    torch.from_numpy(types).long())
        tloss = ternie.ErniePretrainingCriterion()(
            tl, tn, torch.from_numpy(mlm).long(),
            torch.from_numpy(nsp).long())
    np.testing.assert_allclose(float(tloss), float(np.asarray(jloss._value)),
                               rtol=1e-5, atol=1e-5)


def test_fused_f32_adamw_trajectory_matches(fused):
    vals, jlosses, _, jfinal = _jax_run(False, STEPS)
    tlosses, tfinal = _torch_run(_torch_engine(vals), False, STEPS)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=1e-6)
    assert tlosses[-1] < tlosses[0]
    _assert_params_close(tfinal, jfinal, STEPS)


def test_fused_bf16_auto_cast_trajectory_matches(fused):
    vals, jlosses, _, jfinal = _jax_run(True, STEPS)
    tlosses, tfinal = _torch_run(_torch_engine(vals), True, STEPS)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-2)
    for k, v in jfinal.items():
        (g, g_key), (w, w_key), (v0, _) = (
            _split_key_bias(k, a) for a in (tfinal[k], v, vals[k]))
        moved = np.linalg.norm(w - v0)
        assert np.linalg.norm((g - v0) - (w - v0)) <= 0.1 * moved, k
        if w_key is not None:
            assert np.abs(g_key - w_key).max() <= 2 * LR * STEPS * 1.01, k


def test_port_fused_and_unfused_trajectories_agree():
    _, _, vals = build_ernie_pair(seed=0)
    prev = tflags.get_flags(FLAG)[FLAG]
    runs = []
    try:
        for on in (True, False):
            tflags.set_flags({FLAG: on})
            runs.append(_torch_run(_torch_engine(vals), False, STEPS))
    finally:
        tflags.set_flags({FLAG: prev})
    (fl, fp), (ul, up) = runs
    np.testing.assert_allclose(fl, ul, rtol=1e-5, atol=1e-6)
    _assert_params_close(fp, up, STEPS)


def _dropout_grads(vals, recompute):
    """Loss and gradients of one training forward / backward with
    dropout 0.1 under an installed RngState (seed 11)."""
    cfg = dict(ERNIE_TINY, dropout=0.1, attn_dropout=0.1,
               recompute=recompute)
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**cfg), device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    (ids, types), (mlm, nsp) = _batch()
    with trandom.rng_scope(trandom.RngState(11, "cpu")):
        out = tm(torch.from_numpy(ids).long(), torch.from_numpy(types).long())
        loss = ternie.ErniePretrainingCriterion()(
            *out, torch.from_numpy(mlm).long(), torch.from_numpy(nsp).long())
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in tm.named_parameters()}


def test_recompute_with_dropout_replays_the_same_masks():
    _, _, vals = build_ernie_pair(seed=0)
    loss, grads = _dropout_grads(vals, False)
    rloss, rgrads = _dropout_grads(vals, True)
    assert rloss == loss
    for k, g in grads.items():
        assert torch.equal(rgrads[k], g), k
    # dropout really fired
    _, tm, _ = build_ernie_pair(seed=0)
    (ids, types), (mlm, nsp) = _batch()
    out = tm(torch.from_numpy(ids).long(), torch.from_numpy(types).long())
    plain = ternie.ErniePretrainingCriterion()(
        *out, torch.from_numpy(mlm).long(), torch.from_numpy(nsp).long())
    assert plain.item() != loss
    # and a whole engine trajectory repeats bit for bit
    finals = []
    for rc in (False, True):
        eng = _torch_engine(vals, seed=3, dropout=0.1, attn_dropout=0.1,
                            recompute=rc)
        finals.append(_torch_run(eng, False, STEPS))
    assert finals[0][0] == finals[1][0]
    for k, v in finals[0][1].items():
        assert np.array_equal(finals[1][1][k], v), k


def test_recompute_trajectory_matches_reference_recompute(fused):
    vals, jlosses, _, jfinal = _jax_run(False, STEPS, recompute=True)
    tlosses, tfinal = _torch_run(_torch_engine(vals, recompute=True), False,
                                 STEPS)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=1e-6)
    _assert_params_close(tfinal, jfinal, STEPS)


def test_recompute_sequential_replays_dropout():
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet.utils import RecomputeSequential

    torch.manual_seed(0)
    layers = [tnn.Linear(8, 8), tnn.Dropout(0.5), tnn.Linear(8, 8),
              tnn.Dropout(0.5)]
    x = torch.randn(4, 8)
    results = []
    for segments in (None, 2):
        xi = x.clone().requires_grad_(True)
        with trandom.rng_scope(trandom.RngState(9, "cpu")):
            if segments is None:
                out = xi
                for layer in layers:
                    out = layer(out)
            else:
                out = RecomputeSequential(layers, segments)(xi)
        out.square().sum().backward()
        results.append((out.detach(), xi.grad,
                        [p.grad.clone() for layer in layers
                         for p in layer.parameters()]))
        for layer in layers:
            for p in layer.parameters():
                p.grad = None
    (o0, g0, p0), (o1, g1, p1) = results
    assert torch.equal(o0, o1) and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert bool((o0 == 0).any())        # dropout fired


def test_sequence_classification_logits_match():
    from paddle_tpu.engine import state_values
    from paddle_tpu.nlp.transformers.ernie import (
        ErnieConfig as JConfig, ErnieForSequenceClassification as JSeq,
    )

    jm = JSeq(JConfig(**ERNIE_TINY), num_classes=3)
    vals = random_values([(k, tuple(v.shape))
                          for k, v in state_values(jm).items()], seed=6)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    tm = ternie.ErnieForSequenceClassification(
        ternie.ErnieConfig(**ERNIE_TINY), num_classes=3, device="cpu")
    weights.from_paddle_tpu_values(vals, tm)
    jm.eval()
    tm.eval()
    (ids, types), _ = _batch(seed=7)
    jout = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    with torch.no_grad():
        tout = tm(torch.from_numpy(ids).long(),
                  torch.from_numpy(types).long())
    assert tout.shape == (ids.shape[0], 3)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._value),
                               rtol=1e-5, atol=5e-5)
