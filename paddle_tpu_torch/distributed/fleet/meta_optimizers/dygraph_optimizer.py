"""`HybridParallelOptimizer` (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer.py).

It wraps an eager optimizer: `step` first sums, over the model-parallel
group, the gradients of the parameters that sequence parallelism
replicates while each rank sees only its part of the sequence
(``sequence_parallel`` set by the TP layers: LayerNorms, row-parallel
biases), then runs the inner step. Data-parallel averaging belongs to
`DataParallel`. A global-norm clipper over model-parallel shards would
need the norm summed across them: it raises under mp > 1.
"""

from __future__ import annotations

from ...sharding import sync_sequence_parallel_grads

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if hcg is not None and hcg.get_model_parallel_world_size() > 1 \
                and getattr(optimizer, "_grad_clip", None) is not None:
            raise NotImplementedError(
                "gradient clipping across model-parallel shards waits in "
                "ROADMAP queue A item 4")

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def inner_opt(self):
        return self._inner_opt

    def step(self):
        params = [p for p in self._inner_opt._parameter_list or ()
                  if p is not None and p.grad is not None]
        if self._hcg is not None:
            sync_sequence_parallel_grads(
                {i: p.grad for i, p in enumerate(params)},
                dict(enumerate(params)), self._hcg)
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, []

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)
