"""Gradient clipping (counterpart of paddle_tpu/clip.py).

Each clipper has two faces: ``clip(params_grads)`` over ``(param,
grad)`` pairs, which the eager optimizer calls, and ``_clip_fn(grads,
params=None)`` over the engine's ``{name: grad}`` dict after weight
decay and before the update, which pairs each gradient with its
parameter from `params` (``{name: Parameter}``) and clips the pairs.
A parameter whose ``need_clip`` is False (a `ParamAttr` of
``need_clip=False``) is left as it is, and `ClipGradByGlobalNorm` leaves
it out of the norm.

Under a meshed engine ``_clip_fn`` also takes ``norm``, the grid's
`distributed.sharding.MeshNorm`: `ClipGradByGlobalNorm`'s norm is then
the one device's (squares summed over model-parallel shards, ZeRO and
pipeline stages, each parameter counted once) and `ClipGradByNorm`'s
per-parameter norm covers the whole of a parameter split over mp, as
the reference's compiled step takes them. `ClipGradByValue` acts on each
element and needs neither.
"""

from __future__ import annotations

import torch

from .ops.quant_ops import true_div

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm"]


def _clips(p):
    return getattr(p, "need_clip", True)


class ClipGradBase:
    def _clip_one(self, g):
        raise NotImplementedError

    def __call__(self, params_grads):
        return [(p, g) if g is None or not _clips(p) else
                (p, self._clip_one(g)) for p, g in params_grads]

    def _clip_fn(self, grads, params=None, norm=None):
        params = params or {}
        pairs = self([(params.get(k), g) for k, g in grads.items()])
        return {k: g for k, (_, g) in zip(grads, pairs)}

    @staticmethod
    def _sq_sums(grads, params):
        """{name: sum of squares} of the gradients that clipping sees."""
        return {k: torch.sum(torch.square(g.float()))
                for k, g in grads.items() if _clips(params.get(k))}


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element to ``[min, max]`` (min defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_one(self, g):
        return torch.clamp(g, self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient by ``min(clip_norm / max(||g||, 1e-12), 1)``,
    its own l2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g, sq=None):
        norm = torch.sqrt(torch.sum(torch.square(g)) if sq is None else sq)
        scale = torch.clamp_max(
            true_div(self.clip_norm, torch.clamp_min(norm, 1e-12)), 1.0)
        return g * scale

    def _clip_fn(self, grads, params=None, norm=None):
        if norm is None:
            return super()._clip_fn(grads, params)
        params = params or {}
        sq = norm.param_sq(self._sq_sums(grads, params))
        return {k: self._clip_one(g, sq[k].to(g.dtype)) if k in sq else g
                for k, g in grads.items()}


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken in float32 over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _scale(self, grads):
        if not grads:
            return torch.ones(())
        sq = sum(torch.sum(torch.square(g.float())) for g in grads)
        global_norm = torch.sqrt(sq)
        return true_div(self.clip_norm,
                        torch.clamp_min(global_norm, self.clip_norm))

    def __call__(self, params_grads):
        scale = self._scale([g for p, g in params_grads
                             if g is not None and _clips(p)])
        return self._apply(params_grads, scale)

    @staticmethod
    def _apply(params_grads, scale):
        return [(p, g) if g is None or not _clips(p) else
                (p, g * scale.to(g.dtype)) for p, g in params_grads]

    def _clip_fn(self, grads, params=None, norm=None):
        if norm is None:
            return super()._clip_fn(grads, params)
        params = params or {}
        global_norm = torch.sqrt(norm.total_sq(self._sq_sums(grads,
                                                             params)))
        scale = true_div(self.clip_norm,
                         torch.clamp_min(global_norm, self.clip_norm))
        pairs = self._apply([(params.get(k), g) for k, g in grads.items()],
                            scale)
        return {k: g for k, (_, g) in zip(grads, pairs)}


# legacy aliases (fluid names)
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
