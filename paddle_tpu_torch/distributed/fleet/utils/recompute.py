"""Activation recomputation (counterpart of
paddle_tpu/distributed/fleet/utils/recompute.py).

``recompute(function, *args)`` runs `function` without keeping its
intermediate activations; the backward runs it again to rebuild them
(``torch.utils.checkpoint``, non-reentrant). The reference gets the
same effect from ``jax.checkpoint`` inside the compiled step, where the
replay folds in the same PRNG key, so a recomputed dropout drops the
same elements.

Here that has to be arranged. torch's checkpoint restores only torch's
default generators, while the port's dropout draws from the installed
`framework.random.RngState`: hidden dropout from its ``torch.Generator``
and attention dropout from its seed counter (``next_seed``). A plain
checkpoint would replay with other masks and silently give wrong
gradients. So the first run notes where both streams stand (and the
amp policy in force, and whether an engine step's low-precision routing
is on), and the replay restores them, reinstalls the state, the policy
and the routing, and afterwards puts the streams back where the replay
found them. Both runs hide the low-precision delayed-scaling region
(`ops.lowp.suppress_region`), as the reference's checkpointed
sub-traces do: their matmuls quantize with dynamic scales. Outside
autograd (no grad, or no input needing one) `function` simply runs.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .... import amp
from ....framework import random as _random
from ....ops import lowp as _lowp

__all__ = ["recompute", "RecomputeSequential"]


def recompute(function, *args, **kwargs):
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled() or not any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return function(*args, **kwargs)
    state = _random.installed()
    policy = amp.policy()
    routed = _lowp.in_engine_scope()
    first = {"snap": None}

    def run(*a):
        if first["snap"] is None:
            first["snap"] = state.snapshot() if state is not None else ()
            with _lowp.suppress_region():
                return function(*a, **kwargs)
        # the replay in backward: the first run's masks, casts and routing
        here = state.snapshot() if state is not None else None
        if state is not None:
            state.restore(first["snap"])
        try:
            with _random.rng_scope(state), amp.policy_scope(policy), \
                    _lowp.engine_scope(routed), _lowp.suppress_region():
                return function(*a, **kwargs)
        finally:
            if state is not None:
                state.restore(here)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state)


class RecomputeSequential:
    """Run a list of layers in `segments` recomputed segments."""

    def __init__(self, layers, segments=1):
        self.layers = layers
        self.segments = segments

    def __call__(self, x):
        n = len(self.layers)
        seg = max(n // self.segments, 1)
        i = 0
        while i < n:
            chunk = self.layers[i:i + seg]

            def run_chunk(inp, chunk=chunk):
                for layer in chunk:
                    inp = layer(inp)
                return inp

            x = recompute(run_chunk, x)
            i += seg
        return x
