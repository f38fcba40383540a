"""Gradient clipping (counterpart of paddle_tpu/clip.py): the global-norm
clipper the engine applies to the ``{name: grad}`` dict after weight
decay and before the update."""

from __future__ import annotations

import torch

from .ops.quant_ops import true_div

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken in float32 over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip_fn(self, grads):
        sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        global_norm = torch.sqrt(sq)
        scale = true_div(self.clip_norm,
                         torch.clamp_min(global_norm, self.clip_norm))
        return {k: g * scale.to(g.dtype) for k, g in grads.items()}

