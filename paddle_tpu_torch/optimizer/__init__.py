"""Optimizers (counterpart of paddle_tpu/optimizer): the base class with
parameter groups, per-parameter attributes and the eager API, the update
rules `SGD`, `Momentum`, `Adam`, `AdamW`, `Adamax`, `Adagrad`,
`Adadelta`, `RMSProp`, `LarsMomentum` (``Lars``) and `Lamb`, the
regularizers `L1Decay` / `L2Decay`, and the LR schedulers of `lr` (a
scheduler passed as ``learning_rate`` is read by `get_lr`; the caller
steps it).

Each optimizer is a per-parameter rule over a state dict with the
reference's names (``velocity``; ``moment1``, ``moment2``,
``beta1_pow``, ``beta2_pow``; ...), so a state carried over from
paddle_tpu's engine loads name for name (``weights.
from_paddle_tpu_opt_state``). The update is the reference's arithmetic
in float32, in its order, with the learning rate a float32 device
scalar, and it writes the parameter and its state IN PLACE (the
reference returns new arrays). Given ``keep``, a device bool, the writes
are ``where(keep, new, old)``: a skipped step (the engine's loss scaling
and anomaly guard) leaves parameter and state bit for bit, with no copy
of them taken beforehand and no host synchronisation. No rule reads a
value back to the host.

Two paths drive the rules, as in the reference:

* `paddle_tpu_torch.engine.Engine` folds coupled decay into the
  gradients (`decay_gradients`: ``coeff * p`` under L2, ``coeff *
  sign(p)`` under L1), clips, then calls `apply_gradients` with each
  parameter's `_leaf_meta` (its decay coefficient, its learning-rate
  multiplier, a decoupled-decay or hyperparameter override).
* The eager API: ``loss.backward(); opt.step(); opt.clear_grad()``.
  `step` reads ``p.grad`` of the optimizer's parameters, adds the
  coupled decay as the reference's eager ``_preprocess`` does (``coeff
  * p`` for either regularizer, as written there), clips with the
  clipper's ``(param, grad)`` call, and runs the rule with ``lr *
  multiplier``; `state_dict` / `set_state_dict` carry its accumulators
  under the reference's keys.

A parameter's own regularizer (`ParamAttr` or a parameter group's
``weight_decay``) wins over the optimizer's. Name-based rules
(``apply_decay_param_fun``, LARS's ``exclude_from_weight_decay``) read
the parameter's ``name``: its `ParamAttr` name or the automatic one
`nn.Layer` gives (``linear_3.bias``), as in the reference; a bare string
passed as the parameter stands for its name.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "LarsMomentum", "Lars", "Lamb",
           "L1Decay", "L2Decay", "LRScheduler", "lr"]


class _Decay:
    def __init__(self, coeff):
        self.coeff = float(coeff)


class L2Decay(_Decay):
    pass


class L1Decay(_Decay):
    pass


def _as_decay(wd):
    if wd is None or isinstance(wd, _Decay):
        return wd
    return L2Decay(float(wd))


def _name_of(p):
    """The name name-based rules read: a string stands for itself, a
    parameter gives its ``name`` (None when it has none)."""
    return p if isinstance(p, str) else getattr(p, "name", None)


def _lr_mult(p):
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


def _leaf_lr(lr, mult):
    """A parameter's rate: the float32 device scalar `lr` times its
    multiplier (both the engine and the eager path scale it so)."""
    return lr * mult if mult != 1.0 else lr


def _write(keep, op, dst, *args):
    """``dst <- op(*args)`` in place; where the device bool `keep` is
    false, `dst` keeps its value."""
    if keep is None:
        op(*args, out=dst)
    else:
        torch.where(keep, op(*args), dst, out=dst)


def _set(keep, dst, value):
    """``dst <- value`` in place (under `keep` as `_write`)."""
    if keep is None:
        dst.copy_(value)
    else:
        torch.where(keep, value, dst, out=dst)


def _lo(x, dtype):
    """A rule's Python constant `x` as the reference's arithmetic uses it
    beside a tensor of `dtype`: its Python numbers are weakly typed and
    take that dtype, so a bf16 / f16 rule multiplies by `x` rounded to
    it (torch would keep the constant in f32). Returned as a Python
    float; float32 rounds it at the op as it is."""
    if dtype == torch.float32:
        return x
    return float(torch.tensor(x, dtype=dtype))


def _ones():
    return torch.ones((), dtype=torch.float32)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                # parameter groups: each group's rate and decay become
                # the parameters' own attributes, as in the reference
                flat = []
                for group in parameters:
                    for p in group["params"]:
                        if "learning_rate" in group:
                            attr = getattr(p, "optimize_attr", None)
                            if attr is None:
                                attr = p.optimize_attr = {}
                            attr["learning_rate"] = group["learning_rate"]
                        if "weight_decay" in group:
                            p.regularizer = _as_decay(group["weight_decay"])
                        flat.append(p)
                parameters = flat
        self._parameter_list = parameters
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._weight_decay = _as_decay(weight_decay)
        self._grad_clip = grad_clip
        self._accumulators = {}     # id(param) -> state dict (eager path)
        self._lr_scalars = {}       # device -> (lr, its float32 scalar)
        self._global_step = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "can't set_lr when learning rate is an LRScheduler")
        self._learning_rate = float(value)

    # -- the rule ------------------------------------------------------------
    def _init_state(self, param):
        return {}

    def _hyper(self):
        return {}

    def _decoupled_weight_decay(self):
        return False

    def _rule(self, param, grad, state, lr, keep, **hyper):
        raise NotImplementedError

    def _leaf_meta(self, p):
        """Per-parameter update metadata of parameter `p` (or of a bare
        name): the coupled decay's coefficient and whether it is L1 (the
        parameter's regularizer wins over the optimizer's), and its
        learning-rate multiplier. Subclasses add ``decoupled_coeff`` or
        ``hyper_overrides``."""
        decay = getattr(p, "regularizer", None)
        if decay is None:
            decay = self._weight_decay
        coeff, l1 = 0.0, False
        if decay is not None and not self._decoupled_weight_decay():
            coeff, l1 = decay.coeff, isinstance(decay, L1Decay)
        return {"coeff": coeff, "l1": l1, "lr_mult": _lr_mult(p)}

    def _hyper_for(self, p, meta=None):
        """The rule's hyperparameters for `p` (its meta's overrides on
        top of `_hyper`)."""
        meta = self._leaf_meta(p) if meta is None else meta
        h = self._hyper()
        if "decoupled_coeff" in meta:
            h = dict(h, coeff=meta["decoupled_coeff"])
        if "hyper_overrides" in meta:
            h = {**h, **meta["hyper_overrides"]}
        return h

    # -- the engine path -----------------------------------------------------
    def decay_gradients(self, params, grads, metas):
        """Coupled decay folded into the gradients before clipping (the
        reference's ``decay_gradients_tree``): ``g + coeff * p``, or
        ``g + coeff * sign(p)`` under L1Decay."""
        out = {}
        for k, g in grads.items():
            m = metas[k]
            if m["coeff"]:
                p = params[k].detach()
                reg = torch.sign(p) if m.get("l1") else p
                g = g + m["coeff"] * reg.to(g.dtype)
            out[k] = g
        return out

    @torch.no_grad()
    def apply_gradients(self, params, grads, states, lr, metas, keep=None):
        """Update every parameter of the ``{name: Parameter}`` dict in
        place from its gradient and state; `lr` is a float32 scalar
        tensor on the parameters' device (times each parameter's
        multiplier), and `keep` (a device bool, or None for always) says
        whether the update takes effect."""
        for k, p in params.items():
            m = metas[k]
            self._rule(p, grads[k], states[k],
                       _leaf_lr(lr, m.get("lr_mult", 1.0)), keep,
                       **self._hyper_for(k, m))

    # -- the eager API -------------------------------------------------------
    def _lr_scalar(self, device):
        """The current rate as a float32 scalar on `device`, made anew
        only when the rate changes (as the engine keeps its own)."""
        lr = self.get_lr()
        kept = self._lr_scalars.get(device)
        if kept is None or kept[0] != lr:
            kept = self._lr_scalars[device] = (lr, torch.full(
                (), lr, dtype=torch.float32, device=device))
        return kept[1]

    def _state_for(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p.detach())
        return st

    def _preprocess(self, params_grads):
        """Coupled decay as the reference's eager path adds it (``g +
        coeff * p`` for either regularizer), then the clipper."""
        out = []
        for p, g in params_grads:
            decay = getattr(p, "regularizer", None)
            if decay is None:
                decay = self._weight_decay
            if decay is not None and not self._decoupled_weight_decay():
                g = g + decay.coeff * p.detach()
            out.append((p, g))
        if self._grad_clip is not None:
            out = self._grad_clip(out)
        return out

    @torch.no_grad()
    def step(self):
        """One update of every parameter with a gradient (``p.grad``),
        in place."""
        self._global_step += 1
        pg = [(p, p.grad) for p in self._parameter_list or ()
              if p is not None and p.requires_grad and p.grad is not None]
        for p, g in self._preprocess(pg):
            plr = _leaf_lr(self._lr_scalar(p.device), _lr_mult(p))
            self._rule(p.data, g, self._state_for(p), plr, None,
                       **self._hyper_for(p))

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or ():
            if p is None or p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The dygraph minimize: one `step` from the gradients that
        ``loss.backward()`` left (it does not run the backward)."""
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list or ()]

    def state_dict(self):
        """``global_step``, each accumulator as a numpy array under
        ``"<name>.<state key>"`` (the parameter's name, else
        ``param_<i>``), and the scheduler's state under
        ``LR_Scheduler``."""
        sd = {"global_step": self._global_step}
        for i, p in enumerate(self._parameter_list or ()):
            st = self._accumulators.get(id(p))
            if st is None:
                continue
            name = _name_of(p) or f"param_{i}"
            for k, v in st.items():
                sd[f"{name}.{k}"] = v.detach().cpu().numpy()
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        missing = []
        for i, p in enumerate(self._parameter_list or ()):
            name = _name_of(p) or f"param_{i}"
            st = self._init_state(p.detach())
            found = False
            for k, v in st.items():
                kk = f"{name}.{k}"
                if kk not in state_dict:
                    kk = f"param_{i}.{k}"
                if kk in state_dict:
                    v.copy_(torch.as_tensor(np.asarray(state_dict[kk])))
                    found = True
            if found:
                self._accumulators[id(p)] = st
            elif st:
                missing.append(name)
        if missing:
            warnings.warn(
                "optimizer.set_state_dict found no saved state for "
                f"parameters {missing[:5]}{'...' if len(missing) > 5 else ''}"
                " — their accumulators stay at fresh initialisation",
                stacklevel=2)
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])


# ---------------------------------------------------------------------------
# update rules (the reference's, from paddle/fluid/operators/optimizers/)
# ---------------------------------------------------------------------------


class SGD(Optimizer):
    def _rule(self, param, grad, state, lr, keep):
        _write(keep, torch.sub, param, param, lr * grad.to(param.dtype))


class Momentum(Optimizer):
    """Heavy-ball momentum, ``v = momentum * v + g`` then ``p -= lr * v``
    (Nesterov: ``p -= lr * (g + momentum * v)``)."""

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
        momentum = _lo(momentum, param.dtype)
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
        one = _ones().to(param.device)
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
    """Adam with decoupled weight decay, ``p * (1 - lr * coeff)`` before
    the Adam update; ``apply_decay_param_fun(name)`` False exempts a
    parameter. ``lr_ratio`` is accepted and, as in the reference, not
    applied."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode)
        self._lr_ratio = lr_ratio
        self._coeff = weight_decay.coeff if isinstance(
            weight_decay, _Decay) else float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_weight_decay(self):
        return True

    def _hyper(self):
        return dict(super()._hyper(), coeff=self._coeff)

    def _leaf_meta(self, p):
        meta = super()._leaf_meta(p)
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(_name_of(p) or ""):
            meta["decoupled_coeff"] = 0.0
        return meta

    def _rule(self, param, grad, state, lr, keep, *, beta1, beta2, epsilon,
              coeff):
        # decoupled decay applied to the param before the adam update
        super()._rule(param, grad, state, lr, keep, beta1=beta1, beta2=beta2,
                      epsilon=epsilon, base=param * (1.0 - lr * coeff))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param),
                "beta1_pow": _ones().to(param.device)}

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _rule(self, param, grad, state, lr, keep, *, beta1, beta2, epsilon):
        dt = param.dtype
        g = grad.to(dt)
        m, u, b1p = state["moment"], state["inf_norm"], state["beta1_pow"]
        _write(keep, torch.add, m, _lo(beta1, dt) * m,
               _lo(1 - beta1, dt) * g)
        _write(keep, torch.maximum, u, _lo(beta2, dt) * u, torch.abs(g))
        _write(keep, torch.mul, b1p, b1p, beta1)
        step = (lr / (1 - b1p)).to(dt) * m / (u + _lo(epsilon, dt))
        _write(keep, torch.sub, param, param, step)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": torch.full_like(param, self._initial)}

    def _hyper(self):
        return {"epsilon": self._epsilon}

    def _rule(self, param, grad, state, lr, keep, *, epsilon):
        g = grad.to(param.dtype)
        mom = state["moment"]
        _write(keep, torch.add, mom, mom, g * g)
        _write(keep, torch.sub, param, param,
               lr * g / (torch.sqrt(mom) + _lo(epsilon, param.dtype)))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def _hyper(self):
        return {"epsilon": self._epsilon, "rho": self._rho}

    def _rule(self, param, grad, state, lr, keep, *, epsilon, rho):
        dt = param.dtype
        g = grad.to(dt)
        rho1, rho, epsilon = (_lo(c, dt) for c in (1 - rho, rho, epsilon))
        asg, asu = state["avg_squared_grad"], state["avg_squared_update"]
        _write(keep, torch.add, asg, rho * asg, rho1 * g * g)
        # the step reads the OLD squared-update average
        update = g * torch.sqrt(asu + epsilon) / torch.sqrt(asg + epsilon)
        _write(keep, torch.add, asu, rho * asu, rho1 * update * update)
        _write(keep, torch.sub, param, param, lr * update)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, param):
        return {"mean_square": torch.zeros_like(param),
                "mean_grad": torch.zeros_like(param),
                "momentum": torch.zeros_like(param)}

    def _hyper(self):
        return {"rho": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum, "centered": self._centered}

    def _rule(self, param, grad, state, lr, keep, *, rho, epsilon, momentum,
              centered):
        dt = param.dtype
        g = grad.to(dt)
        rho1, rho, epsilon, momentum = (_lo(c, dt) for c in (
            1 - rho, rho, epsilon, momentum))
        ms, mg, mom = state["mean_square"], state["mean_grad"], \
            state["momentum"]
        _write(keep, torch.add, ms, rho * ms, rho1 * g * g)
        if centered:
            _write(keep, torch.add, mg, rho * mg, rho1 * g)
            denom = torch.sqrt(ms - mg * mg + epsilon)
        else:
            denom = torch.sqrt(ms + epsilon)
        _write(keep, torch.add, mom, momentum * mom, lr * g / denom)
        _write(keep, torch.sub, param, param, mom)


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling with momentum:
    ``local_lr = lr * lars_coeff * ||p|| / (||g|| + decay * ||p|| +
    eps)`` (0 where the denominator is 0), ``v = mu * v + local_lr * (g
    + decay * p)``, ``p -= v``. A parameter whose name contains one of
    ``exclude_from_weight_decay`` gets decay 0."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=0.0, exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_decay = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _init_state(self, param):
        # f32 whatever the parameter's dtype: the rule computes in f32
        # (the reference's starts as zeros_like(param) and is f32 from
        # its first update on)
        return {"velocity": torch.zeros_like(param, dtype=torch.float32)}

    def _hyper(self):
        return {"momentum": self._momentum, "coeff": self._lars_coeff,
                "decay": self._lars_decay, "epsilon": self._epsilon}

    def _excluded(self, name):
        return bool(name) and any(sub in name for sub in self._exclude)

    def _leaf_meta(self, p):
        meta = super()._leaf_meta(p)
        if self._excluded(_name_of(p)):
            meta["hyper_overrides"] = {"decay": 0.0}
        return meta

    def _rule(self, param, grad, state, lr, keep, *, momentum, coeff, decay,
              epsilon):
        g = grad.float()
        p32 = param.float()
        p_norm = torch.sqrt(torch.sum(p32 * p32))
        g_norm = torch.sqrt(torch.sum(g * g))
        denom = g_norm + decay * p_norm + epsilon
        local_lr = torch.where(
            denom > 0, lr * coeff * p_norm / torch.clamp_min(denom, 1e-30),
            torch.zeros_like(denom))
        v = state["velocity"]
        _write(keep, torch.add, v, momentum * v, local_lr * (g + decay * p32))
        _set(keep, param, (p32 - v).to(param.dtype))


Lars = LarsMomentum


class Lamb(Optimizer):
    """Adam moments with the reference's folded bias correction, the
    decoupled decay added to the ratio, and the layer's trust ratio
    ``||p|| / ||r||`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn`` is accepted and, as in the
    reference, not applied."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._coeff = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, param):
        # f32 moments, as Adam's
        one = _ones().to(param.device)
        return {"moment1": torch.zeros_like(param, dtype=torch.float32),
                "moment2": torch.zeros_like(param, dtype=torch.float32),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _hyper(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "coeff": self._coeff}

    def _rule(self, param, grad, state, lr, keep, *, beta1, beta2, epsilon,
              coeff):
        g = grad.float()
        p32 = param.float()
        m, v = state["moment1"], state["moment2"]
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        _write(keep, torch.add, m, beta1 * m, (1 - beta1) * g)
        _write(keep, torch.add, v, beta2 * v, (1 - beta2) * g * g)
        _write(keep, torch.mul, b1p, b1p, beta1)
        _write(keep, torch.mul, b2p, b2p, beta2)
        corr2 = torch.sqrt(1.0 - b2p)
        r = (corr2 / (1.0 - b1p)) * (
            m / (torch.sqrt(v) + epsilon * corr2)) + coeff * p32
        p_norm = torch.sqrt(torch.sum(p32 * p32))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        _set(keep, param, (p32 - lr * trust * r).to(param.dtype))
