"""nn.utils (ref paddle_tpu/nn/utils): weight and spectral norm as
reparameterisations of an existing layer's weight.

Both replace ``layer.<name>`` by derived parameters and recompute the
effective weight in a forward pre-hook with autograd ops, so gradients
reach the derived parameters and the layer's own forward is untouched.
State names are the reference's: ``<name>_g`` (a 1-D [k] vector over
`dim`, or a scalar with ``dim=None``) and ``<name>_v`` for weight norm;
``<name>_orig`` and the buffers ``<name>_u`` / ``<name>_v`` for spectral
norm, whose vectors start from numpy's ``default_rng(0)`` draws as the
reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..layer.layers import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _norm_except(v, dim):
    axes = [i for i in range(v.dim()) if i != dim]
    return (v * v).sum(dim=axes, keepdim=True) ** 0.5


def weight_norm(layer, name="weight", dim=0):
    """``layer.<name>`` as ``g * v / ||v||``, the norm over every axis
    but `dim` (over all with ``dim=None``)."""
    w = getattr(layer, name).detach()
    d = None if dim is None else dim % w.dim()
    if d is None:
        g0 = torch.sqrt((w * w).sum())
    else:
        g0 = torch.sqrt((w * w).sum(dim=[i for i in range(w.dim())
                                         if i != d]))
    del layer._parameters[name]
    layer.add_parameter(name + "_g", Parameter(g0.clone()))
    layer.add_parameter(name + "_v", Parameter(w.clone()))
    bshape = None if d is None else [
        w.shape[d] if i == d else 1 for i in range(w.dim())]

    def hook(lyr, inputs):
        vv = getattr(lyr, name + "_v")
        gg = getattr(lyr, name + "_g")
        if d is None:
            nrm = ((vv * vv).sum()) ** 0.5
        else:
            nrm = _norm_except(vv, d)
            gg = gg.reshape(bshape)
        object.__setattr__(lyr, name, vv * (gg / nrm))

    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_state = (name, dim, handle, hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` (from the current g and v) back into one
    plain parameter."""
    state = getattr(layer, "_weight_norm_state", None)
    if state is None or state[0] != name:
        raise ValueError(f"weight_norm not applied to '{name}'")
    _, _, handle, hook = state
    hook(layer, None)
    w = layer.__dict__.pop(name).detach().clone()
    handle.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.add_parameter(name, Parameter(w))
    del layer._weight_norm_state
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``layer.<name>`` divided by its largest singular value, estimated
    by power iteration on the persistent buffers u, v (updated each
    forward without gradient); sigma = u^T W v carries the gradient to
    ``<name>_orig``. `dim` defaults to 1 for Linear and the transposed
    convs (weight ``[in, out, ...]``), else 0."""
    w = getattr(layer, name).detach()
    if dim is None:
        cls = type(layer).__name__
        dim = 1 if (cls == "Linear" or "Transpose" in cls) and w.dim() > 1 \
            else 0
    d = dim % w.dim()
    h = w.shape[d]
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(h).astype(np.float32)
    u0 /= max(np.linalg.norm(u0), eps)
    v0 = rng.standard_normal(w.numel() // h).astype(np.float32)
    v0 /= max(np.linalg.norm(v0), eps)
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", Parameter(w.clone()))
    layer.register_buffer(name + "_u", torch.as_tensor(u0).to(w.device))
    layer.register_buffer(name + "_v", torch.as_tensor(v0).to(w.device))

    def _l2(x):
        return x / torch.clamp_min(torch.linalg.vector_norm(x), eps)

    def hook(lyr, inputs):
        worig = getattr(lyr, name + "_orig")
        u_buf, v_buf = getattr(lyr, name + "_u"), getattr(lyr, name + "_v")
        with torch.no_grad():
            wmat = worig.movedim(d, 0).reshape(h, -1)
            u, v = u_buf, v_buf
            for _ in range(max(1, n_power_iterations)):
                v = _l2(wmat.T @ u)
                u = _l2(wmat @ v)
            u_buf.copy_(u)
            v_buf.copy_(v)
            rest = [s for i, s in enumerate(worig.shape) if i != d]
            uvt = torch.outer(u, v).reshape([h] + rest).movedim(0, d)
        sigma = (worig * uvt).sum()
        object.__setattr__(lyr, name, worig / sigma)

    handle = layer.register_forward_pre_hook(hook)
    layer._spectral_norm_state = (name, handle)
    hook(layer, None)
    return layer
