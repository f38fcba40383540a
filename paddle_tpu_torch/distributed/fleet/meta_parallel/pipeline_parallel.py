"""Pipeline-parallel execution (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py:
``pipeline_spmd`` for uniform stages, ``pipeline_spmd_hetero`` for
stages that differ, and `PipelineParallel`).

The reference runs the whole schedule as one compiled program: stage
weights placed over a 'pp' mesh axis, a scan whose ticks ppermute the
activations, and jax AD of that scan as the backward, which is the
GPipe schedule (all forwards, then all backwards). Here each pp rank is
a process holding its own stage, and `pipeline_spmd_hetero` runs that
same schedule eagerly: for each micro-batch the first stage reads it,
every stage runs its program and hands its output to the next stage,
the last stage computes the loss; then, micro-batch by micro-batch in
the same order, the last stage back-propagates its loss and every stage
returns the gradient of its input to the stage before. Activations and
their gradients move over the pp group with ``batch_isend_irecv``
(`collective.exchange`), each boundary with its own shape and dtype.
`pipeline_spmd` is the uniform case: an embedding on the first stage,
the same block program on every stage, a head on the last.
"""

from __future__ import annotations

import torch

from ...collective import exchange

__all__ = ["pipeline_spmd", "pipeline_spmd_hetero", "PipelineParallel"]


def pipeline_spmd_hetero(hcg, num_micro, stage, in_spec, out_spec, device,
                         loss_scale=None, on_micro=None):
    """One GPipe step of this rank's stage.

    ``stage(m, x)`` runs this stage on micro-batch m: `x` is the
    activation received from the previous stage (None on the first
    stage, which reads micro-batch m itself); it returns the activation
    for the next stage, or on the last stage the scalar loss.
    `in_spec` / `out_spec`: ``(shape, dtype)`` of the activation this
    stage receives / sends (None on the first / last stage; a stage's
    output in another dtype, as under O2 autocast, is cast to it, and so
    is its gradient on the way back). Backpropagates every micro-batch's
    loss (times `loss_scale`, a device scalar, when given; gradients
    accumulate in the parameters' ``.grad``) and returns the sum of the
    losses on the last stage (detached, unscaled), None elsewhere.
    ``on_micro(m)`` runs before micro-batch m's forward."""
    st = hcg.get_stage_id()
    first, last = hcg.is_first_stage(), hcg.is_last_stage()
    prev = None if first else hcg.get_rank_from_stage(st - 1)
    nxt = None if last else hcg.get_rank_from_stage(st + 1)
    saved = []
    total = None
    for m in range(num_micro):
        if on_micro is not None:
            on_micro(m)
        x_in = None
        if not first:
            x_in = torch.empty(in_spec[0], dtype=in_spec[1], device=device)
            exchange(recvs=[(x_in, prev)])
            x_in.requires_grad_()
        out = stage(m, x_in)
        if last:
            total = out.detach() if total is None else total + out.detach()
        else:
            exchange(sends=[(out.detach().to(out_spec[1]), nxt)])
        saved.append((x_in, out))
    for x_in, out in saved:
        if last:
            (out if loss_scale is None else out * loss_scale).backward()
        else:
            g = torch.empty(out_spec[0], dtype=out_spec[1], device=device)
            exchange(recvs=[(g, nxt)])
            out.backward(g.to(out.dtype))
        if not first:
            exchange(sends=[(x_in.grad, prev)])
    return total


def pipeline_spmd(hcg, num_micro, embed, blocks, head, act_shape,
                  act_dtype, device, loss_scale=None, on_micro=None):
    """One GPipe step of this rank's stage of a uniform pipeline.

    embed(m) -> the first stage's input activation of micro-batch m;
    blocks(x) -> this stage's output activation;
    head(y, m) -> the last stage's scalar loss of micro-batch m.
    `act_shape` / `act_dtype` describe the activation passed between
    stages. The rest as `pipeline_spmd_hetero`."""
    first, last = hcg.is_first_stage(), hcg.is_last_stage()

    def stage(m, x):
        y = blocks(embed(m) if first else x)
        return head(y, m) if last else y

    spec = (act_shape, act_dtype)
    return pipeline_spmd_hetero(hcg, num_micro, stage,
                                None if first else spec,
                                None if last else spec, device,
                                loss_scale, on_micro)


class PipelineParallel:
    """The dygraph wrapper of a `PipelineLayer`
    (``pipeline_parallel.py:32`` of the reference): `train_batch` runs
    one global batch of ``pipeline_configs["accumulate_steps"]``
    micro-batches through a `distributed.pp_engine.PipelineEngine`."""

    def __init__(self, layers, hcg, strategy):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = strategy.pipeline_configs
        self.micro_batch_size = cfg["micro_batch_size"]
        self.accumulate_steps = cfg["accumulate_steps"]
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self._engine = None

    def parameters(self):
        return self._layers.parameters()

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    device=None):
        """One step on the global batch ``data = (inputs, labels)``;
        returns the mean loss (a float32 0-dim device tensor)."""
        from ...pp_engine import PipelineEngine

        if self._engine is None:
            self._engine = PipelineEngine(
                self._layers, optimizer, self._hcg,
                micro_batch_size=self.micro_batch_size,
                accumulate_steps=self.accumulate_steps, device=device)
        inputs, labels = data
        loss = self._engine.train_batch(inputs, labels)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The whole layer's forward on this rank (every stage is built
        here until an engine frees the others) and, with
        `compute_loss`, its loss."""
        inputs, labels = data
        dev = next(self._layers.parameters()).device
        with torch.no_grad():
            out = self._layers(torch.as_tensor(inputs, device=dev))
            if compute_loss and self._layers._loss_fn is not None:
                return self._layers._loss_fn(
                    out, torch.as_tensor(labels, device=dev))
        return out
