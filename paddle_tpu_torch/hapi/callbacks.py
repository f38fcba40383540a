"""hapi callbacks (counterpart of paddle_tpu/hapi/callbacks.py), the
reference's own Python: `Callback`, `CallbackList`, `ProgBarLogger`,
`ModelCheckpoint`, `EarlyStopping`, `LRScheduler` (steps the optimizer's
scheduler by step or by epoch), `ReduceLROnPlateau` and `VisualDL`
(scalars as JSON lines)."""

from __future__ import annotations

import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        def dispatch(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return dispatch


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in logs.items())
            print(f"step {step}/{self.steps or '?'} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in (logs or {}).items())
            print(f"Epoch {epoch + 1} done ({dur:.1f}s) - {items}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = " - ".join(
                f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"Eval - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


def _monitored_value(logs, monitor):
    """Look up a monitored metric in eval logs.

    Model.evaluate prefixes its keys with ``eval_`` — accept both the
    bare name (reference spelling, e.g. ``loss``) and the prefixed one.
    Streaming metrics report lists; use the first element.
    """
    cur = logs.get(monitor)
    if cur is None:
        cur = logs.get("eval_" + monitor)
    if isinstance(cur, (list, tuple)):
        cur = cur[0] if cur else None
    return cur


def _improvement_cmp(mode, monitor, min_delta):
    if mode == "max" or (mode == "auto" and "acc" in monitor):
        return lambda cur, best: cur > best + min_delta
    return lambda cur, best: cur < best - min_delta


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0
        self._epoch = 0
        self.better = _improvement_cmp(mode, monitor, self.min_delta)

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self._epoch = 0
        # A baseline is a bar the metric must clear, not a best value to
        # update: a run that never beats it accrues wait every eval
        # (reference hapi/callbacks.py EarlyStopping.on_train_begin).
        self.best = self.baseline

    def on_epoch_begin(self, epoch=None, logs=None):
        if epoch is not None:
            self._epoch = epoch

    def on_eval_end(self, logs=None):
        cur = _monitored_value(logs or {}, self.monitor)
        if cur is None:
            return
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
            save_dir = self.params.get("save_dir")
            if self.save_best_model and save_dir and self.model is not None:
                self.model.save(os.path.join(save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                # the 0-based epoch that triggered the stop (from
                # on_epoch_begin), not a count of evaluations
                self.stopped_epoch = self._epoch
                if self.verbose:
                    print(f"Epoch {self.stopped_epoch + 1}: "
                          "Early stopping.")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") and callable(
            getattr(lr, "step", None)) and not isinstance(lr, float) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer LR when a monitored metric stops improving.
    Only a plain-float optimizer LR can be stepped down (a scheduler's
    is skipped with a warning)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support a "
                             "factor >= 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        self.best = None
        self.better = _improvement_cmp(mode, monitor, self.min_delta)

    def on_eval_end(self, logs=None):
        cur = _monitored_value(logs or {}, self.monitor)
        if cur is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    if not isinstance(opt._learning_rate, float):
                        import warnings

                        warnings.warn(
                            "ReduceLROnPlateau only supports a float "
                            "learning rate; the optimizer uses an "
                            "LRScheduler, skipping the reduction.")
                    else:
                        old = opt.get_lr()
                        new = max(old * self.factor, self.min_lr)
                        if old - new > 1e-12:
                            opt.set_lr(new)
                            if self.verbose:
                                print(f"ReduceLROnPlateau: lr {old:.6g} "
                                      f"-> {new:.6g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalars of each training batch appended as JSON lines to
    ``<log_dir>/scalars.jsonl`` (VisualDL's call surface)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        import json

        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **(logs or {})}) + "\n")
