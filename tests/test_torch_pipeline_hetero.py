"""The heterogeneous pipeline: `PipelineLayer`, `PipelineEngine` and
`PipelineParallel` against the reference's.

* `PipelineLayer` built from the sweep's descriptions (a shared
  embedding, the blocks, the final norm, the tied logits) names and
  shapes its parameters as the reference's (``run_function.<n>.*``) and
  cuts the same stages.
* Two gloo ranks on the CPU (spawned once for the module through
  tests/torch_dist_workers.py): the sweep's ``pp2.hetero`` trains on the
  "hetero" schedule with every warning an error, within the sweep's rtol
  of ``__graft_entry__.baseline_losses`` and within 1e-5 of the
  reference's dropout-free trajectory (the 8-rank sweep in
  tests/test_torch_distributed.py holds its parameters too); the same
  layer under Lamb, which the hetero contract refuses, falls back to
  gradient accumulation with the reference's warning and repeats the
  reference's one-device Lamb trajectory within 1e-5;
  `fleet.distributed_model` of the layer is a `PipelineParallel` whose
  `train_batch` repeats the engine's losses.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
import __graft_entry__ as graft  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed import pp_engine as jpp  # noqa: E402
from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import (  # noqa: E402
    PipelineLayer as JPipelineLayer, SharedLayerDesc as JShared,
)
from paddle_tpu.engine import Engine as JEngine  # noqa: E402
from paddle_tpu.nlp.transformers import (  # noqa: E402
    GPTConfig, GPTPretrainingCriterion,
)
from paddle_tpu.nlp.transformers.gpt import (  # noqa: E402
    GPTDecoderLayer, GPTEmbeddings,
)

from torch_dist_workers import (  # noqa: E402
    SWEEP_GPT, SWEEP_LR, hetero_layer, run_ranks,
)

STEPS = 2
RTOL = dict((c[0], c[7]) for c in graft.SWEEP_CONFIGS)["pp2.hetero"]


def _batch():
    return graft._sweep_batch(types.SimpleNamespace(vocab_size=128))


def _reference_layer(num_stages):
    cfg = GPTConfig(**dict(SWEEP_GPT, use_parallel=False))
    crit = GPTPretrainingCriterion(cfg)

    def tied_logits(base, x):
        from paddle_tpu.core.dispatch import apply

        return apply("matmul_v2", x, base.word_embeddings.weight,
                     trans_y=True)

    descs = [JShared("embed", GPTEmbeddings, None, "weight", cfg)]
    descs += [GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)]
    descs.append(jnn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps))
    descs.append(JShared("embed", GPTEmbeddings, tied_logits, "weight", cfg))
    return JPipelineLayer(descs, num_stages=num_stages,
                          loss_fn=lambda lg, lb: crit(lg, lb))


def _reference_trajectory(master, opt_cls):
    """The reference's one-device run of the sweep model at attention
    dropout 0 under `opt_cls` (lr 0.05)."""
    model, crit, cfg = graft._sweep_model(use_parallel=False)
    for layer in model.gpt.layers:
        layer.attn.attn_dropout = 0.0
    graft._set_state(model, master)
    opt = getattr(paddle.optimizer, opt_cls)(learning_rate=SWEEP_LR,
                                            parameters=model.parameters())
    eng = JEngine(model, opt, lambda out, y: crit(out, y))
    x, y = _batch()
    return [float(eng.train_batch((x,), (y,)).item()) for _ in range(STEPS)]


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_pipeline_layer_names_shapes_and_stages_are_the_references(stages):
    got = hetero_layer(stages)
    want = _reference_layer(stages)
    g = {k: tuple(v.shape) for k, v in got.state_dict().items()}
    w = {k: tuple(v.shape) for k, v in want.state_dict().items()}
    assert g == w
    assert list(g) == list(w)
    assert got.segment_parts == want.segment_parts
    assert [got.stage_of_layer(i) for i in range(len(got.run_function))] \
        == [want.stage_of_layer(i) for i in range(len(want.run_function))]


@pytest.fixture(scope="module")
def baseline():
    return graft.baseline_losses()


@pytest.fixture(scope="module")
def ranks(baseline, tmp_path_factory):
    _, master = baseline
    x, y = _batch()
    return run_ranks(2, "hetero_cases", (master, x, y, STEPS),
                     str(tmp_path_factory.mktemp("hetero")))


def test_pp2_hetero_runs_the_hetero_schedule(baseline, ranks):
    ref, master = baseline
    res = ranks[0]["hetero"]
    assert res["schedule"] == "hetero" and res["warnings"] == []
    err = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], ref))
    assert err <= RTOL, (res["losses"], ref)
    want = _reference_trajectory(master, "SGD")
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


def test_refused_contract_falls_back_with_the_references_warning(baseline,
                                                                 ranks):
    _, master = baseline
    res = ranks[0]["fallback"]
    assert res["schedule"] == "accum"
    # the reference's warning for the same refusal (its engine built on a
    # stand-in group of two stages: the contract is checked first)
    hcg = types.SimpleNamespace(get_pipe_parallel_world_size=lambda: 2)
    jl = _reference_layer(2)
    eng = jpp.PipelineEngine(jl, paddle.optimizer.Lamb(
        learning_rate=SWEEP_LR, parameters=jl.parameters()), hcg,
        accumulate_steps=4)
    with pytest.warns(UserWarning) as seen:
        eng._build()
    assert eng.schedule == "accum"
    assert res["warnings"] == [str(w.message) for w in seen]
    want = _reference_trajectory(master, "Lamb")
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


def test_fleet_wraps_a_pipeline_layer_in_pipeline_parallel(ranks):
    assert ranks[0]["wrapped"]["type"] == "PipelineParallel"
    np.testing.assert_array_equal(ranks[0]["wrapped"]["losses"],
                                  ranks[0]["hetero"]["losses"])
