"""Training callbacks (``paddle_tpu/hapi/callbacks.py``): `Callback`,
`CallbackList`, `ProgBarLogger`, `ModelCheckpoint`, `EarlyStopping`,
`LRScheduler`, `JSONLLogger` (also named `VisualDL`: one JSON line per
epoch) and `ReduceLROnPlateau`.  A callback reads the optimizer's
``learning_rate``, a number or an ``optimizer.lr.LRScheduler``."""
import json
import os
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

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
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in (logs or {}).items() if k != "step"
            )
            print(f"step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"epoch {epoch + 1} done in {dt:.1f}s: {logs}")


class ModelCheckpoint(Callback):
    """`Model.save` to ``save_dir/{epoch}`` every `save_freq` epochs and
    to ``save_dir/final`` when training ends."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Sets ``model.stop_training`` after `patience` epochs in which
    `monitor` (or ``eval_`` + it) did not improve by `min_delta`."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.is_better = lambda a, b: a > b + self.min_delta
        else:
            self.is_better = lambda a, b: a < b - self.min_delta

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            cur = (logs or {}).get("eval_" + self.monitor)
        if cur is None:
            return
        if self.best is None or self.is_better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = self.model._optimizer
        from ..optimizer.lr import LRScheduler as Sched

        return (opt.learning_rate if opt and isinstance(
            opt.learning_rate, Sched) else None)

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class JSONLLogger(Callback):
    """Metrics sink (VisualDL-callback stand-in): one JSON line per epoch."""

    def __init__(self, log_path="train_log.jsonl"):
        super().__init__()
        self.log_path = log_path

    def on_epoch_end(self, epoch, logs=None):
        rec = {"epoch": epoch}
        for k, v in (logs or {}).items():
            if isinstance(v, (int, float, str)):
                rec[k] = v
            elif isinstance(v, np.floating):
                rec[k] = float(v)
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


VisualDL = JSONLLogger


class ReduceLROnPlateau(Callback):
    """Scale the LR by `factor` after `patience` epochs without improvement
    of `monitor`.  Works with both plain-float LRs (set_lr) and
    LRScheduler-driven optimizers (the scheduler's base learning rate is
    scaled)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0,
                 verbose=1):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def _improved(self, cur):
        if self._best is None:
            return True
        if self.mode == "min":
            return cur < self._best - self.min_delta
        return cur > self._best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        # eval metrics publish as 'eval_<name>' (model.py epoch-end logs),
        # same fallback EarlyStopping uses
        cur = logs.get(self.monitor, logs.get("eval_" + self.monitor))
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self._improved(cur):
            self._best = cur
            self._wait = 0
            return
        if self._cooldown_left > 0:
            # epochs inside the cooldown window never count toward
            # patience (Keras/reference semantics)
            self._cooldown_left -= 1
            self._wait = 0
            return
        self._wait += 1
        if self._wait < self.patience:
            return
        opt = self.model._optimizer
        if opt is None:
            return
        from ..optimizer.lr import LRScheduler as Sched

        sched = opt.learning_rate
        if isinstance(sched, Sched):
            new = max(sched.base_lr * self.factor, self.min_lr)
            sched.base_lr = new
            sched.last_lr = max(sched.last_lr * self.factor, self.min_lr)
        else:
            new = max(float(opt.get_lr()) * self.factor, self.min_lr)
            opt.set_lr(new)
        if self.verbose:
            print(f"ReduceLROnPlateau: epoch {epoch}: lr -> {new:.3e}")
        self._wait = 0
        self._cooldown_left = self.cooldown
