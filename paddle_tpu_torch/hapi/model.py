"""The high-level `Model` (``paddle_tpu/hapi/model.py``): `prepare`,
the one-batch steps `train_batch`, `eval_batch` and `predict_batch`,
the loops `fit`, `evaluate` and `predict` over an ``io.DataLoader``
with callbacks, and `save`, `load` and `summary`.

Inputs and labels go to the device of the network's parameters (the
card, where the network has none); a dataset handed to a loop is
loaded onto that device.  `prepare` takes ``amp_configs`` and ignores
it, as the JAX package does: AMP is ``amp.auto_cast`` around the
caller's own steps."""
import os

import numpy as np
import torch

from ..io.dataloader import DataLoader
from ..metric import _host
from . import callbacks as cbks
from .model_summary import _device_of


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]

    @property
    def device(self):
        """The device of the network's first parameter or buffer; the
        card where it has neither."""
        return _device_of(self.network)

    # ---- one batch ----
    def train_batch(self, inputs, labels=None, update=True):
        """Forward, the summed losses' backward and, with `update`, the
        optimizer's step and `clear_grad`.  Returns (the losses as
        floats, the metrics' values on this batch)."""
        self.network.train()
        inputs = self._to_list(inputs)
        labels = [self._to_tensor(x) for x in self._to_list(labels)]
        outputs = self.network(*[self._to_tensor(x) for x in inputs])
        losses = self._compute_loss(outputs, labels)
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        return self._loss_values(losses), metrics

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with torch.no_grad():
            inputs = self._to_list(inputs)
            labels = [self._to_tensor(x) for x in self._to_list(labels)]
            outputs = self.network(*[self._to_tensor(x) for x in inputs])
            losses = self._compute_loss(outputs, labels)
            metrics = self._update_metrics(outputs, labels)
        return self._loss_values(losses), metrics

    def predict_batch(self, inputs):
        """The network's outputs in eval mode, as numpy arrays."""
        self.network.eval()
        with torch.no_grad():
            inputs = self._to_list(inputs)
            outputs = self.network(*[self._to_tensor(x) for x in inputs])
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return [_host(o) for o in outs]

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            return []
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        losses = self._loss(*(list(outs) + list(labels)))
        return losses if isinstance(losses, (list, tuple)) else [losses]

    def _update_metrics(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        res = {}
        for m in self._metrics:
            stats = m.compute(*(list(outs) + list(labels)))
            if isinstance(stats, (list, tuple)):
                r = m.update(*stats)
            else:
                r = m.update(stats)
            names = m.name()
            names = names if isinstance(names, list) else [names]
            vals = r if isinstance(r, (list, tuple)) else [r]
            for n, v in zip(names, vals):
                res[n] = v
        return res

    @staticmethod
    def _loss_values(losses):
        return [float(loss.detach().reshape(-1)[0]) for loss in losses]

    @staticmethod
    def _to_list(x):
        if x is None:
            return []
        return list(x) if isinstance(x, (list, tuple)) else [x]

    def _to_tensor(self, x):
        """`x` on the network's device; an array as the loader turns one
        into a tensor (float64 as float32)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            x = torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64
                                 else np.require(x, requirements="C"))
        return x.to(self.device)

    # ---- loops ----
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """`epochs` passes over `train_data` (a dataset or a DataLoader),
        `evaluate` on `eval_data` every `eval_freq` epochs, `save` to
        ``save_dir/{epoch}`` every `save_freq`; the callbacks see
        train begin, each epoch's begin and end, each batch's begin and
        end, and train end.  `num_iters` stops each epoch after that
        many batches; `accumulate_grad_batches` is accepted and, as in
        the JAX package, every batch steps the optimizer."""
        train_loader = self._as_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      num_workers) \
            if eval_data is not None else None

        cblist = cbks.CallbackList(callbacks or [])
        cblist.set_model(self)
        cblist.set_params({
            "epochs": epochs, "steps": self._safe_len(train_loader),
            "verbose": verbose,
            "metrics": ["loss"] + self._metric_names(),
        })
        cblist.on_train_begin()
        self.stop_training = False

        logs = {}
        for epoch in range(epochs):
            cblist.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, data in enumerate(train_loader):
                cblist.on_train_batch_begin(step)
                ins, lbs = self._split_batch(data)
                losses, metrics = self.train_batch(ins, lbs)
                logs = {"loss": losses[0] if losses else 0.0, **metrics,
                        "step": step}
                cblist.on_train_batch_end(step, logs)
                if num_iters is not None and step + 1 >= num_iters:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cblist.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if self.stop_training:
                break
        cblist.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        """The mean of the batches' first loss and each metric's
        accumulated value over `eval_data`."""
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        total_loss, count = 0.0, 0
        for step, data in enumerate(loader):
            ins, lbs = self._split_batch(data)
            losses, _ = self.eval_batch(ins, lbs)
            if losses:
                total_loss += losses[0]
                count += 1
            if num_iters is not None and step + 1 >= num_iters:
                break
        logs = {"loss": total_loss / max(count, 1)}
        for m in self._metrics:
            names = m.name()
            names = names if isinstance(names, list) else [names]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            logs.update(dict(zip(names, vals)))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """Each batch's outputs (numpy), or with `stack_outputs` each
        output concatenated over the batches."""
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for data in loader:
            ins, _ = self._split_batch(data, has_label=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _metric_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _split_batch(self, data, has_label=True):
        if isinstance(data, (list, tuple)):
            data = list(data)
            if has_label and len(data) >= 2:
                n_in = len(self._inputs) if self._inputs else len(data) - 1
                return data[:n_in], data[n_in:]
            return data, []
        return [data], []

    @staticmethod
    def _safe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, places=self.device, batch_size=batch_size,
                          shuffle=shuffle, drop_last=drop_last,
                          num_workers=num_workers)

    # ---- save / load ----
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with an
        optimizer, ``path.pdopt`` (its state dict), in `framework.save`'s
        format.  ``training=False`` (an inference model through
        ``jit.save``) is not ported."""
        from ..framework import save as fsave

        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports through jit.save, "
                "which is not ported (ROADMAP.md queue 1 item 7)")
        fsave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The network's state from ``path.pdparams`` (either package's):
        each name the network has is copied in; with `skip_mismatch` a
        shape that differs is skipped, else it raises.  The optimizer's
        state from ``path.pdopt`` where that exists, unless
        `reset_optimizer`."""
        from ..framework import load as fload

        dev = self.device
        state = fload(path + ".pdparams", device=dev)
        own = self.network.state_dict(keep_vars=True)
        with torch.no_grad():
            for name, value in state.items():
                if name not in own:
                    continue
                t = own[name]
                if tuple(value.shape) != tuple(t.shape):
                    if skip_mismatch:
                        continue
                    raise ValueError(f"{name}: shape {tuple(value.shape)} "
                                     f"!= {tuple(t.shape)}")
                t.copy_(value)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt",
                                                 device=dev))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """The network's parameter totals (`hapi.summary` without a
        dry run)."""
        from .model_summary import summary

        return summary(self.network)
