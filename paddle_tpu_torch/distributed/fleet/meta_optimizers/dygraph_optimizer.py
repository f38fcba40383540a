"""`HybridParallelOptimizer` (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer.py).

It wraps an eager optimizer: `step` first sums, over the model-parallel
group, the gradients of the parameters that sequence parallelism
replicates while each rank sees only its part of the sequence
(``sequence_parallel`` set by the TP layers: LayerNorms, row-parallel
biases), then runs the inner step with its clipper wrapped in
`HybridParallelClipGrad`, which takes the norms one device would take
(`distributed.sharding.MeshNorm`: a parameter split over mp counted
over all its shards, a replicated one once). Data-parallel averaging
belongs to `DataParallel`.
"""

from __future__ import annotations

from ...sharding import MeshNorm, sync_sequence_parallel_grads

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad"]


class HybridParallelClipGrad:
    """`clip` over ``(param, grad)`` pairs held in model-parallel shards:
    its norms summed over the hybrid group `hcg` (ref
    ``dygraph_optimizer.py:19``)."""

    def __init__(self, clip, hcg):
        self._clip = clip
        self._hcg = hcg

    def __call__(self, params_grads):
        live = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        params = {i: params_grads[i][0] for i in live}
        grads = {i: params_grads[i][1] for i in live}
        if not live:
            return params_grads
        out = self._clip._clip_fn(grads, params,
                                  norm=MeshNorm(params, self._hcg))
        return [(p, out.get(i, g)) for i, (p, g) in enumerate(params_grads)]

    def _clip_fn(self, grads, params=None, norm=None):
        return self._clip._clip_fn(grads, params, norm=norm)


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def inner_opt(self):
        return self._inner_opt

    def step(self):
        inner = self._inner_opt
        params = [p for p in inner._parameter_list or ()
                  if p is not None and p.grad is not None]
        if self._hcg is None:
            inner.step()
            return
        sync_sequence_parallel_grads(
            {i: p.grad for i, p in enumerate(params)},
            dict(enumerate(params)), self._hcg)
        clip = inner._grad_clip
        if clip is not None:
            inner._grad_clip = HybridParallelClipGrad(clip, self._hcg)
        try:
            inner.step()
        finally:
            inner._grad_clip = clip

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
