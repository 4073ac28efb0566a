"""paddle.callbacks: the port's own copy of ``paddle_tpu/hapi/
callbacks.py`` (reference python/paddle/hapi/callbacks.py: Callback /
CallbackList, ProgBarLogger, ModelCheckpoint, EarlyStopping,
LRScheduler), the hook surface ``Model.fit`` drives."""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler"]


class Callback:
    def __init__(self):
        self.model = None
        self.params: Dict[str, Any] = {}

    def set_model(self, model) -> None:
        self.model = model

    def set_params(self, params: Dict[str, Any]) -> None:
        self.params = params

    # -- hooks (reference callback signature set) -------------------------
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb: Callback) -> None:
        self.callbacks.append(cb)

    def set_model(self, model) -> None:
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params) -> None:
        for cb in self.callbacks:
            cb.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-step console logging (reference ProgBarLogger, simplified to
    line logging: a terminal progress bar adds nothing to a log)."""

    def __init__(self, log_freq: int = 10, verbose: int = 1):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and step % self.log_freq == 0:
            extras = " ".join(f"{k}: {v:.4f}" for k, v in logs.items()
                              if isinstance(v, (int, float)))
            epochs = self.params.get("epochs", "?")
            print(f"Epoch {self._epoch + 1}/{epochs} step {step} {extras}")  # noqa: print

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done in {time.time() - self._t0:.1f}s")  # noqa: print


class ModelCheckpoint(Callback):
    """Periodic save (reference ModelCheckpoint: save_freq in epochs)."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, f"epoch_{epoch}"))

    def on_train_end(self, logs=None):
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference
    EarlyStopping: monitor/patience/min_delta/mode/baseline)."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, min_delta: float = 0.0,
                 baseline: Optional[float] = None,
                 save_best_model: bool = False):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = baseline if baseline is not None else (
            -np.inf if mode == "max" else np.inf)
        self.save_best_model = save_best_model
        self.wait = 0
        self.stopped_epoch = -1

    def _improved(self, value: float) -> bool:
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        value = float(value[0] if isinstance(value, (list, tuple))
                      else value)
        if self._improved(value):
            self.best = value
            self.wait = 0
            save_dir = self.params.get("save_dir")
            if self.save_best_model and save_dir:
                os.makedirs(save_dir, exist_ok=True)
                self.model.save(os.path.join(save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True


class LRScheduler(Callback):
    """Step the optimizer's LRScheduler (reference LRScheduler callback:
    by_step or by_epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()
