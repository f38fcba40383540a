"""Optimizers (counterpart of paddle_tpu/optimizer): the base class,
`Momentum`, `Adam` and `AdamW`, driven by `paddle_tpu_torch.engine.Engine`, and the
LR schedulers of `lr` (a scheduler passed as ``learning_rate`` is read
by `get_lr`; the caller steps it).

Each optimizer is a per-parameter rule over a state dict with the
reference's names (``velocity``; ``moment1``, ``moment2``,
``beta1_pow``, ``beta2_pow``), so a state carried over from paddle_tpu's engine loads
name for name (``weights.from_paddle_tpu_opt_state``). The update is the
reference's arithmetic in float32, with the learning rate a float32
device scalar, and it writes the parameter and its state IN PLACE (the
reference returns new arrays). Given ``keep``, a device bool, the writes
are ``where(keep, new, old)``: a skipped step (the engine's loss scaling
and anomaly guard) leaves parameter and state bit for bit, with no copy
of them taken beforehand and no host synchronisation.

Parameters are known by their structured (state-dict) names: the
engine passes them, and `AdamW`'s ``apply_decay_param_fun`` is called
with them (the reference calls it with its auto-generated names such
as ``linear_3.bias``; a predicate on suffixes like ``bias`` or
substrings like ``norm`` reads the same under both).
"""

from __future__ import annotations

import torch

from . import lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW", "L2Decay",
           "LRScheduler", "lr"]


class L2Decay:
    def __init__(self, coeff):
        self.coeff = float(coeff)


def _write(keep, op, dst, *args):
    """``dst <- op(*args)`` in place; where the device bool `keep` is
    false, `dst` keeps its value."""
    if keep is None:
        op(*args, out=dst)
    else:
        torch.where(keep, op(*args), dst, out=dst)


def _as_decay(wd):
    if wd is None or isinstance(wd, L2Decay):
        return wd
    return L2Decay(float(wd))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._weight_decay = _as_decay(weight_decay)
        self._grad_clip = grad_clip

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "can't set_lr when learning rate is an LRScheduler")
        self._learning_rate = float(value)

    def _init_state(self, param):
        return {}

    def _hyper(self):
        return {}

    def _decoupled_weight_decay(self):
        return False

    def _leaf_meta(self, name):
        """Per-parameter update metadata: the coupled L2 coefficient
        (folded into the gradient before clipping)."""
        decay = self._weight_decay
        coeff = decay.coeff if decay is not None and \
            not self._decoupled_weight_decay() else 0.0
        return {"coeff": coeff}

    def _rule(self, param, grad, state, lr, keep, **hyper):
        raise NotImplementedError

    def decay_gradients(self, params, grads, metas):
        """Coupled L2 decay: ``g + coeff * p`` where the meta asks for it
        (the reference's ``decay_gradients_tree``)."""
        return {k: g + metas[k]["coeff"] * params[k].detach()
                if metas[k]["coeff"] else g for k, g in grads.items()}

    @torch.no_grad()
    def apply_gradients(self, params, grads, states, lr, metas, keep=None):
        """Update every parameter of the ``{name: Parameter}`` dict in
        place from its gradient and state; `lr` is a float32 scalar
        tensor on the parameters' device, and `keep` (a device bool, or
        None for always) says whether the update takes effect."""
        hyper = self._hyper()
        for k, p in params.items():
            h = hyper
            if "decoupled_coeff" in metas[k]:
                h = dict(hyper, coeff=metas[k]["decoupled_coeff"])
            self._rule(p, grads[k], states[k], lr, keep, **h)


class Momentum(Optimizer):
    """Heavy-ball momentum, ``v = momentum * v + g`` then ``p -= lr * v``
    (Nesterov: ``p -= lr * (g + momentum * v)``); a float
    ``weight_decay`` is coupled L2, folded into the gradient."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _hyper(self):
        return {"momentum": self._momentum, "nesterov": self._use_nesterov}

    def _rule(self, param, grad, state, lr, keep, *, momentum, nesterov):
        g = grad.to(param.dtype)
        v = state["velocity"]
        _write(keep, torch.add, v, v * momentum, g)
        step = g + momentum * v if nesterov else v
        _write(keep, torch.sub, param, param, lr * step)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if lazy_mode:
            raise NotImplementedError("lazy_mode (sparse rows) is not "
                                      "ported yet")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, param):
        one = torch.ones((), dtype=torch.float32, device=param.device)
        return {"moment1": torch.zeros_like(param, dtype=torch.float32),
                "moment2": torch.zeros_like(param, dtype=torch.float32),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _rule(self, param, grad, state, lr, keep, *, beta1, beta2, epsilon,
              base=None):
        """`base` is the parameter's value the update starts from (the
        decoupled-decayed one for AdamW; `param` itself by default)."""
        g = grad.float()
        m, v = state["moment1"], state["moment2"]
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        # on a skipped step m, v and the powers keep their old values and
        # the update below, computed from them, is discarded by the where
        _write(keep, torch.add, m, m * beta1, (1 - beta1) * g)
        _write(keep, torch.add, v, v * beta2, (1 - beta2) * g * g)
        _write(keep, torch.mul, b1p, b1p, beta1)
        _write(keep, torch.mul, b2p, b2p, beta2)
        # the reference's folded bias correction: one param-sized divide
        #   m/(1-b1p) / (sqrt(v/(1-b2p)) + eps)
        #   == sqrt(1-b2p)/(1-b1p) * m / (sqrt(v) + eps*sqrt(1-b2p))
        corr2 = torch.sqrt(1.0 - b2p)
        lr_t = lr * corr2 / (1.0 - b1p)
        upd = lr_t * (m / (torch.sqrt(v) + epsilon * corr2))
        base = param if base is None else base
        _write(keep, torch.sub, param, base.float(), upd)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode)
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        self._coeff = weight_decay.coeff if isinstance(
            weight_decay, L2Decay) else float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_weight_decay(self):
        return True

    def _hyper(self):
        return dict(super()._hyper(), coeff=self._coeff)

    def _leaf_meta(self, name):
        meta = super()._leaf_meta(name)
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            meta["decoupled_coeff"] = 0.0
        return meta

    def _rule(self, param, grad, state, lr, keep, *, beta1, beta2, epsilon,
              coeff):
        # decoupled decay applied to the param before the adam update
        super()._rule(param, grad, state, lr, keep, beta1=beta1, beta2=beta2,
                      epsilon=epsilon, base=param * (1.0 - lr * coeff))
