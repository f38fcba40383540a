"""Training engine (counterpart of paddle_tpu/engine.py's `Engine`).

``Engine(layer, optimizer, loss_fn).train_batch(inputs, labels)`` runs
one step eagerly, in the reference's order: forward and loss (the loss
in float32), backward, coupled weight decay, gradient clipping, then the
optimizer's update (``engine.py:414-474`` of the reference). Dropout
draws from the engine's own `framework.random.RngState` on its device,
installed for the forward with `rng_scope`. There is no compile
step: PyTorch runs each op as it comes. The anomaly guard, loss
scaling, meshes, ZeRO and buffer donation are not ported.

``engine.state`` exposes the parameters (the layer's own, updated in
place) and the optimizer state under the reference's names, keyed by
the parameters' structured names; a tied table appears once.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .framework import random as _random

__all__ = ["Engine", "TrainState"]


class TrainState:
    def __init__(self, params, opt_state, buffers, step=0):
        self.params = params
        self.opt_state = opt_state
        self.buffers = buffers
        self.step = step


class Engine:
    """Drives the training of `layer` on `device` (default cuda; raises
    when no GPU is visible). One random source feeds every dropout of the
    step: an `RngState` on the device from `seed` (by default a draw
    from torch's default generator, which `paddle_tpu_torch.seed`
    seeds). Engines built with one seed on two devices drop the same
    attention elements."""

    def __init__(self, layer, optimizer, loss_fn, grad_clip=None,
                 device=None, seed=None):
        self.device = resolve_device(device)
        self.layer = layer.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._grad_clip = grad_clip if grad_clip is not None else \
            optimizer._grad_clip
        params = dict(layer.named_parameters())
        self.state = TrainState(
            params,
            {k: optimizer._init_state(p) for k, p in params.items()},
            dict(layer.named_buffers()))
        self._metas = {k: optimizer._leaf_meta(k) for k in params}
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, ()))
        self.rng = _random.RngState(seed, self.device)
        self._lr = (None, None)     # (value, its float32 device scalar)

    def _tensor(self, x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def train_batch(self, inputs, labels=()):
        """One step; returns the loss as a float32 0-dim device tensor
        (no host synchronisation)."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        inputs = [self._tensor(x) for x in inputs]
        labels = [self._tensor(x) for x in labels]
        params = self.state.params
        for p in params.values():
            p.grad = None
        with _random.rng_scope(self.rng):
            loss = self.loss_fn(self.layer(*inputs), *labels).float()
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, as in
        # the reference (its moments still decay)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        opt = self.optimizer
        grads = opt.decay_gradients(params, grads, self._metas)
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_fn(grads)
        if self._lr[0] != opt.get_lr():
            self._lr = (opt.get_lr(), torch.tensor(
                opt.get_lr(), dtype=torch.float32, device=self.device))
        opt.apply_gradients(params, grads, self.state.opt_state,
                            self._lr[1], self._metas)
        self.state.step += 1
        return loss.detach()
