"""Port parity: paddle_tpu_torch's optimizer update and global-norm
clipping against paddle_tpu's compiled-engine path (``param_metas`` ->
``decay_gradients_tree`` -> ``ClipGradByGlobalNorm._clip_fn`` ->
``apply_gradients_tree``), on the same numpy parameters and gradients
over 4 steps.

The update is elementwise float32 arithmetic in the same order on both
sides; the only sum is the clipper's global norm (summed in another
order), so parameters and moments agree within rtol 1e-6 (atol 1e-7
for entries near 0).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.core.tensor import Parameter as JParameter

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.clip import ClipGradByGlobalNorm as TClip

SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "norm.weight": (5,)}
STEPS, LR = 4, 0.05


def _no_decay(name):
    return not (name.endswith("bias") or "norm" in name)


def _opts(kind):
    if kind == "adam_l2":          # coupled L2 decay, folded in pre-clip
        return (paddle.optimizer.Adam(learning_rate=LR, weight_decay=0.1),
                topt.Adam(learning_rate=LR, weight_decay=0.1))
    return (paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.1,
                                   apply_decay_param_fun=_no_decay),
            topt.AdamW(learning_rate=LR, weight_decay=0.1,
                       apply_decay_param_fun=_no_decay))


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("kind", ["adam_l2", "adamw_selective"])
def test_update_matches_reference_engine_path(kind, clip):
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    jopt, topt_ = _opts(kind)
    # the reference resolves decay per Parameter by its name
    jmetas = jopt.param_metas({k: JParameter(jnp.asarray(v), name=k)
                               for k, v in p0.items()})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = {k: jopt._init_state(v) for k, v in jp.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    tst = {k: topt_._init_state(v) for k, v in tp.items()}
    tmetas = {k: topt_._leaf_meta(k) for k in tp}
    lr = torch.tensor(LR)
    for g in grads:
        jg = jopt.decay_gradients_tree(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jmetas)
        tg = topt_.decay_gradients(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tmetas)
        if clip is not None:
            jg, tg = JClip(clip)._clip_fn(jg), TClip(clip)._clip_fn(tg)
        jp, jst = jopt.apply_gradients_tree(jp, jg, jst,
                                            jnp.asarray(LR, jnp.float32),
                                            metas=jmetas)
        topt_.apply_gradients(tp, tg, tst, lr, tmetas)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for name, v in jst[k].items():
            np.testing.assert_allclose(tst[k][name].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k}.{name}")
    # apply_decay_param_fun / coupled decay really changed something
    assert ("decoupled_coeff" in tmetas["fc.bias"]) == (kind != "adam_l2")
