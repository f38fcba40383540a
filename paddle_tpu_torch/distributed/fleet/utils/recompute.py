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

``FLAGS_remat_policy`` picks what a segment keeps, as `remat_wrapper`
resolves it in the reference: ``full`` keeps nothing (the checkpoint
above), ``dots_saveable`` keeps the outputs of the segment's matrix
products (aten ``mm`` / ``addmm`` / ``bmm``) through torch's selective
checkpointing and recomputes the rest, ``none`` keeps everything (no
checkpoint; the low-precision region stays hidden, as in the
reference), and ``auto`` takes the site's default (``full`` for
`recompute`). A kernel launched outside aten, such as the flash
attention's, is replayed under ``dots_saveable`` as under ``full``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import checkpoint

from .... import amp
from ....framework import random as _random
from ....framework.flags import flag
from ....ops import lowp as _lowp

__all__ = ["recompute", "remat_wrapper", "RecomputeSequential"]

_POLICIES = ("full", "dots_saveable", "none")


def _policy(default):
    policy = flag("FLAGS_remat_policy")
    if policy == "auto":
        policy = default
    if policy not in _POLICIES:
        raise ValueError(
            f"FLAGS_remat_policy={policy!r}; expected "
            "auto | full | dots_saveable | none")
    return policy


def _dots_saveable():
    """The selective-checkpoint contexts that keep matrix products."""
    from torch.utils.checkpoint import (
        CheckpointPolicy, create_selective_checkpoint_contexts,
    )

    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default, aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else \
            CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def remat_wrapper(default="full"):
    """``FLAGS_remat_policy`` as a wrapper ``wrap(fn) -> fn'`` whose calls
    run `fn` as a recomputed segment under the resolved policy
    (`default` stands for ``auto``)."""
    policy = _policy(default)
    return lambda fn: functools.partial(_segment, policy, fn)


def recompute(function, *args, **kwargs):
    return _segment(_policy("full"), function, *args, **kwargs)


def _segment(policy, function, *args, **kwargs):
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled() or not any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return function(*args, **kwargs)
    if policy == "none":
        with _lowp.suppress_region():
            return function(*args, **kwargs)
    state = _random.installed()
    cast_policy = amp.policy()
    routed = _lowp.in_engine_scope()
    first = {"snap": None}

    def snapshot():
        # out of the selective checkpoint's dispatch modes, which count
        # the segment's aten calls and must see the same ones twice
        with _disable_current_modes():
            return state.snapshot()

    def restore(snap):
        with _disable_current_modes():
            state.restore(snap)

    def run(*a):
        if first["snap"] is None:
            first["snap"] = snapshot() if state is not None else ()
            with _lowp.suppress_region():
                return function(*a, **kwargs)
        # the replay in backward: the first run's masks, casts and routing
        here = snapshot() if state is not None else None
        if state is not None:
            restore(first["snap"])
        try:
            with _random.rng_scope(state), amp.policy_scope(cast_policy), \
                    _lowp.engine_scope(routed), _lowp.suppress_region():
                return function(*a, **kwargs)
        finally:
            if state is not None:
                restore(here)

    extra = {"context_fn": _dots_saveable} \
        if policy == "dots_saveable" else {}
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra)


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
