"""Port parity: paddle_tpu_torch's GPT against paddle_tpu's on the tiny
config of tests/test_serving_w8a8.py, with the same numpy weights
carried across by `weights.from_paddle_tpu_values`.

- `forward` logits within rtol=atol=1e-5 (f32 sums in other orders),
  and under bf16 O1 ``auto_cast`` bf16 on both sides within one bf16
  ulp of the largest |logit|;
- `_attend_paged` on a hand-built block table: outputs within 1e-5 and
  the scattered pools equal (duplicate null-block writes included);
- `generate` greedy tokens equal (bf16 static cache in both).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import weights
from paddle_tpu_torch.nlp.transformers import gpt as tgpt
from torch_parity import TINY, VOCAB, build_pair


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


def test_forward_logits_match(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 13))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_forward_logits_under_bf16_auto_cast_are_bf16(pair):
    # the tied logits are the reference's `matmul_v2`, on the O1 white
    # list: both packages cast h and the table to bf16 and return bf16
    jm, tm, _ = pair
    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 16))
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jout = jm(paddle.to_tensor(ids.astype(np.int32)))._value
    with torch.no_grad(), tamp.auto_cast(level="O1", dtype="bfloat16"):
        tout = tm(torch.from_numpy(ids))
    assert str(jout.dtype) == "bfloat16"
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    got = tout.float().numpy()
    # one bf16 ulp of the largest |logit|: the products' inputs may
    # round to neighbouring bf16 values on the two sides
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


def test_attend_paged_matches_on_a_hand_built_table(pair):
    jm, tm, _ = pair
    rng = np.random.RandomState(2)
    b, nh, s_new, hd, nb, bs, mb = 3, 4, 5, 16, 9, 4, 3
    q, k, v = (rng.randn(b, nh, s_new, hd).astype(np.float32)
               for _ in range(3))
    kp, vp = (rng.randn(nb, nh, bs, hd).astype(np.float32)
              for _ in range(2))
    # row 0 mid-block, row 1 runs past the table (-> null block),
    # row 2 is an idle slot: every entry is the null block 0
    tables = np.array([[3, 5, 0], [7, 2, 8], [0, 0, 0]], np.int32)
    pos = np.array([2, 9, 0], np.int32)
    jatt = jm.gpt.layers[0].attn
    jo, (jk, jv, _) = jatt._attend_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pos), jnp.asarray(tables))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, (tk2, tv2, (tpos, _)) = tm.gpt.layers[0].attn._attend_paged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tk,
        tv, torch.from_numpy(pos).long(), torch.from_numpy(tables).long())
    assert tk2 is tk and tv2 is tv           # pools updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tpos.numpy(), pos + s_new)


def test_generate_greedy_tokens_equal(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(3).randint(1, VOCAB, (2, 7)).astype(
        np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=12)._value)
    got = tm.generate(ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want[:, 7:].reshape(-1).tolist())) > 2   # not degenerate


def test_weights_roundtrip_and_parallel_config_raises(pair):
    _, tm, vals = pair
    back = weights.to_numpy_values(tm)
    assert list(back) == list(vals)
    for k in vals:
        np.testing.assert_array_equal(back[k], vals[k])
    # GPT's use_parallel=True builds at degree 1 (the dense layers under
    # the same names); so does ERNIE's (ported since), its encoder
    # output equal to the dense model's
    par = tgpt.GPTForPretraining(
        tgpt.GPTConfig(**dict(TINY, use_parallel=True)), device="cpu")
    weights.from_paddle_tpu_values(vals, par)
    ids = torch.arange(12).reshape(2, 6) % TINY["vocab_size"]
    torch.testing.assert_close(par(ids), tm(ids), rtol=0, atol=0)
    from paddle_tpu_torch.nlp.transformers import ernie as ternie
    from torch_parity import ERNIE_TINY
    gen = torch.Generator().manual_seed(0)
    epar, eplain = (ternie.ErnieModel(ternie.ErnieConfig(
        **dict(ERNIE_TINY, use_parallel=p)), gen) for p in (True, False))
    eplain.load_state_dict(epar.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(epar(ids), eplain(ids), rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        weights.from_paddle_tpu_values({"nope": np.zeros(1)}, tm)
