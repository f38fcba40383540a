"""paddle.DataParallel (counterpart of paddle_tpu/dataparallel.py).

Eager data parallelism over the dp group (the hybrid group's, else the
whole world): the wrapped layer runs on this rank's part of the batch,
and after ``loss.backward()`` `apply_collective_grads` averages every
gradient over the group (all-reduced as one flat buffer, then scaled by
1 / nranks, as the reference's compiled all-reduce averages).
`scale_loss` returns the loss unchanged, as the reference's does: the
averaging is in `apply_collective_grads`.
"""

from __future__ import annotations

import torch

from .distributed.collective import _get_default_group
from .distributed.sharding import _all_reduce_coalesced
from .distributed.topology import get_hybrid_communicate_group
from .nn.layer.layers import Layer

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        if group is None:
            hcg = get_hybrid_communicate_group()
            group = hcg.get_data_parallel_group() if hcg is not None \
                else _get_default_group()
        self.group = group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every parameter's gradient over the group (a
        parameter without one counts as a zero gradient)."""
        n = self.group.nranks
        if n <= 1:
            return
        params = [p for p in self._layers.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _all_reduce_coalesced([p.grad for p in params], self.group, 1.0 / n)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    load_dict = set_state_dict
    set_dict = set_state_dict
