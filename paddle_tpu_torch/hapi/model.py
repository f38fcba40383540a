"""paddle.Model — the high-level train / eval / predict API (counterpart
of paddle_tpu/hapi/model.py).

`prepare` takes the optimizer, the loss, the metrics and ``amp_configs``
(level O1 or O2 in bf16 or f16; its loss-scaling knobs go to the
engine's scaler, and in bf16 no scaling is applied unless a scaler knob
is given, as in the reference). With ``jit_compile`` (the default) each
training batch goes through `engine.Engine` on the network's device
under the amp scope (O2: every op not black-listed in the low dtype
over the network's own parameters); without it the eager path runs
``loss.backward(); opt.step(); opt.clear_grad()`` outside any amp scope,
as the reference's eager path does (decorate the network with
`amp.decorate` and step a `amp.GradScaler` for eager O2).
Evaluation and prediction run the network in eval mode without
autograd. `fit` / `evaluate` / `predict` build a `io.DataLoader` on the
network's device when given a dataset; `fit` polls for preemption at
every batch boundary and, when asked to stop, saves the engine's state
under ``<save_dir>/preempt-ckpt`` with a PREEMPTED marker.

`save` writes the network's ``state_dict`` to ``<path>.pdparams`` and
the optimizer's to ``<path>.pdopt`` (`framework.io.save`, readable by
either package). As in the reference, the ``.pdopt`` of a model trained
through the engine holds only ``global_step`` and the scheduler: the
optimizer's eager accumulators, which the engine does not use.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import resolve_device
from ..engine import Engine
from ..io import DataLoader
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model"]

_SCALER_KNOBS = ("init_loss_scaling", "incr_ratio", "decr_ratio",
                 "incr_every_n_steps", "decr_every_n_nan_or_inf")


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._engine = None
        self.stop_training = False
        self._compiled_mode = True
        self._amp_level = None
        self._amp_dtype = "bfloat16"
        self._loss_scale = None

    # -- prepare -------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=True):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        self._compiled_mode = jit_compile
        self._engine = None
        self._amp_level = None
        self._amp_dtype = "bfloat16"
        self._loss_scale = None
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                amp_configs = {"level": amp_configs}
            cfg = dict(amp_configs)
            self._amp_level = cfg.pop("level", "O1")
            self._amp_dtype = cfg.pop("dtype", "bfloat16")
            if self._amp_level in ("O0", None):
                self._amp_level = None
            if cfg.pop("use_dynamic_loss_scaling", True):
                knobs = {k: v for k, v in cfg.items() if k in _SCALER_KNOBS}
                self._loss_scale = knobs if knobs else "dynamic"
            else:
                self._loss_scale = float(
                    cfg.get("init_loss_scaling", 2.0 ** 15))
            # bf16 has f32's exponent range: no scaling unless a scaler
            # knob was given
            if self._amp_dtype == "bfloat16" and not any(
                    k in amp_configs for k in
                    (*_SCALER_KNOBS, "use_dynamic_loss_scaling")):
                self._loss_scale = None
        return self

    # -- single-batch APIs ---------------------------------------------------
    def _device(self):
        for p in self.network.parameters():
            return p.device
        return resolve_device(None)

    def _tensor(self, x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x))
        if not t.is_floating_point():
            t = t.long()
        return t.to(self._device())

    def _ensure_engine(self):
        if self._engine is None:
            self._engine = Engine(self.network, self._optimizer, self._loss,
                                  device=self._device(),
                                  loss_scale=self._loss_scale)
        return self._engine

    def _amp_scope(self):
        if self._amp_level is None:
            return contextlib.nullcontext()
        from .. import amp

        return amp.auto_cast(enable=True, dtype=self._amp_dtype,
                             level=self._amp_level)

    def train_batch(self, inputs, labels=None, update=True):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is None or isinstance(
            labels, (list, tuple)) else [labels]
        if self._compiled_mode:
            eng = self._ensure_engine()
            with self._amp_scope():
                loss = eng.train_batch(inputs, labels or ())
            return [float(loss)]
        self.network.train()
        outputs = self.network(*[self._tensor(x) for x in inputs])
        loss = self._loss(outputs, *[self._tensor(x) for x in labels or []])
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        if self._engine is not None:
            self._engine.sync_to_layer()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = [self._tensor(x) for x in labels or []]
        outputs = self.network(*[self._tensor(x) for x in inputs])
        results = []
        if self._loss is not None and labels:
            results.append(float(self._loss(outputs, *labels)))
        metric_results = []
        for m in self._metrics:
            pred = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            m.update(m.compute(pred, *labels))
            metric_results.append(m.accumulate())
        self.network.train()
        return results, metric_results

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        if self._engine is not None:
            self._engine.sync_to_layer()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        out = self.network(*[self._tensor(x) for x in inputs])
        self.network.train()
        return [o.detach().cpu().numpy() if isinstance(o, torch.Tensor)
                else o for o in (out if isinstance(out, (list, tuple))
                                 else [out])]

    def _emergency_save(self, save_dir, *, epoch, step):
        """The preemption checkpoint: the engine's whole state (params,
        moments, step, random streams) under ``<save_dir>/preempt-ckpt``
        and a PREEMPTED marker. With no save_dir training just stops at
        the batch boundary."""
        from ..distributed import checkpoint as _ckpt
        from ..distributed import preempt as _preempt
        from ..framework import monitor as _monitor

        if not save_dir:
            return
        if self._engine is not None:
            _ckpt.save_train_state(
                os.path.join(save_dir, "preempt-ckpt"), self._engine)
        else:
            self.save(os.path.join(save_dir, "preempt-ckpt", "model"))
        _preempt.write_marker(save_dir, {"epoch": epoch, "step": step})
        _monitor.stat_add("preempt_emergency_saves")

    # -- fit / evaluate / predict --------------------------------------------
    def _loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, places=self._device(), batch_size=batch_size,
                          shuffle=shuffle, drop_last=drop_last,
                          num_workers=num_workers)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        from ..distributed import preempt as _preempt

        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        eval_loader = self._loader(eval_data, batch_size, False, False,
                                   num_workers)
        cbks = CallbackList([ProgBarLogger(log_freq, verbose=verbose)] +
                            (callbacks or []))
        cbks.set_model(self)
        cbks.set_params({"epochs": epochs, "steps": _safe_len(train_loader),
                         "verbose": verbose, "save_dir": save_dir})
        cbks.on_train_begin()
        self.stop_training = False
        # SIGTERM / SIGUSR1 stop training at the next batch boundary
        _preempt.install()
        it = 0
        logs = None
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = _split_batch(batch)
                logs = {"loss": self.train_batch(inputs, labels)[0]}
                cbks.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
                if _preempt.poll():
                    self._emergency_save(save_dir, epoch=epoch, step=step)
                    self.stop_training = True
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, batch_size=batch_size,
                                          verbose=0, num_workers=num_workers)
                logs.update(eval_logs)
                cbks.on_eval_end(eval_logs)
            cbks.on_epoch_end(epoch, logs)
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, False, False,
                              num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = _split_batch(batch)
            res, _ = self.eval_batch(inputs, labels)
            if res:
                losses.append(res[0])
        logs = {}
        if losses:
            logs["eval_loss"] = float(np.mean(losses))
        for m in self._metrics:
            name, acc = m.name(), m.accumulate()
            if isinstance(name, (list, tuple)):
                for n, a in zip(name, acc):
                    logs[f"eval_{n}"] = a
            else:
                logs[f"eval_{name}"] = acc
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, False, False,
                              num_workers)
        outputs = [self.predict_batch(_split_batch(batch)[0])
                   for batch in loader]
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as _save

        if self._engine is not None:
            self._engine.sync_to_layer()
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as _load

        self.network.set_state_dict(_load(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def summary(self, input_size=None, dtype=None):
        total = trainable = 0
        lines = ["-" * 60]
        for name, p in self.network.named_parameters():
            n = p.numel()
            total += n
            if p.requires_grad:
                trainable += n
            lines.append(f"{name:<40} {str(tuple(p.shape)):<18} {n}")
        lines.append("-" * 60)
        lines.append(f"Total params: {total}")
        lines.append(f"Trainable params: {trainable}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}

    def flops(self, input_spec=None):
        """The reference counts a forward's FLOPs from XLA's cost
        analysis, which no PyTorch counter reproduces: not ported."""
        raise NotImplementedError("Model.flops() is not ported yet")


def _split_batch(batch):
    if isinstance(batch, (list, tuple)):
        return [batch[0]], list(batch[1:])
    return [batch], []


def _safe_len(loader):
    try:
        return len(loader)
    except (RuntimeError, TypeError):
        return None
