"""Pipeline-parallel execution (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py,
``pipeline_spmd`` for uniform stages).

The reference runs the whole schedule as one compiled program: stage
weights stacked over a 'pp' mesh axis, a scan whose ticks ppermute the
activations, and jax AD of that scan as the backward, which is the
GPipe schedule (all forwards, then all backwards). Here each pp rank is
a process holding its own ``L / S`` blocks, and `pipeline_spmd` runs
that same schedule eagerly: for each micro-batch the first stage embeds
it, every stage runs its blocks and hands the activation to the next
stage, the last stage computes the loss; then, micro-batch by
micro-batch in the same order, the last stage back-propagates its loss
and every stage returns the gradient of its input activation to the
stage before. Activations and their gradients move over the pp group
with ``batch_isend_irecv`` (`collective.exchange`). Heterogeneous stages
(`PipelineLayer`, ``pipeline_spmd_hetero``) wait in ROADMAP queue A
item 4.
"""

from __future__ import annotations

import torch

from ...collective import exchange

__all__ = ["pipeline_spmd", "PipelineParallel"]


def pipeline_spmd(hcg, num_micro, embed, blocks, head, act_shape,
                  act_dtype, device):
    """One GPipe step of this rank's stage.

    embed(m) -> the first stage's input activation of micro-batch m;
    blocks(x) -> this stage's output activation;
    head(y, m) -> the last stage's scalar loss of micro-batch m.
    `act_shape` / `act_dtype` describe the activation passed between
    stages. Backpropagates every micro-batch's loss (gradients
    accumulate in the parameters' ``.grad``) and returns the sum of the
    losses on the last stage (detached), None elsewhere."""
    stage = hcg.get_stage_id()
    first, last = hcg.is_first_stage(), hcg.is_last_stage()
    prev = None if first else hcg.get_rank_from_stage(stage - 1)
    nxt = None if last else hcg.get_rank_from_stage(stage + 1)
    saved = []
    total = None
    for m in range(num_micro):
        if first:
            x_in = None
            x = embed(m)
        else:
            x_in = torch.empty(act_shape, dtype=act_dtype, device=device)
            exchange(recvs=[(x_in, prev)])
            x = x_in.requires_grad_()
        y = blocks(x)
        if last:
            out = head(y, m)
            total = out.detach() if total is None else total + out.detach()
        else:
            exchange(sends=[(y.detach(), nxt)])
            out = y
        saved.append((x_in, out))
    for x_in, out in saved:
        if last:
            out.backward()
        else:
            g = torch.empty_like(out)
            exchange(recvs=[(g, nxt)])
            out.backward(g)
        if not first:
            exchange(sends=[(x_in.grad, prev)])
    return total


class PipelineParallel:
    """The reference's wrapper of a `PipelineLayer`: waits with
    pp_layers.py / pp_engine.py (ROADMAP queue A item 4)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PipelineParallel over a PipelineLayer (pp_layers.py, "
            "pp_engine.py) waits in ROADMAP queue A item 4: train uniform "
            "pipelines through distributed.hybrid.make_gpt_hybrid_engine")
