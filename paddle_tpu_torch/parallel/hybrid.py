"""The train step (``paddle_tpu/parallel/hybrid.py::CompiledTrainStep``)
on a single device, where the JAX step's ZeRO stage resolves to 0.

A step computes the loss at the parameters before the update, the
backward pass, then the optimizer's fused update, and returns the loss.
The gradients stay in each parameter's ``.grad`` until the next step; a
parameter the loss does not reach (BERT's pooler without NSP labels)
gets a zero gradient, as ``jax.value_and_grad`` gives it, so its
optimizer state advances and weight decay applies.
With ``amp_dtype`` the floating parameters of more than one dimension
enter the loss rounded to that dtype (the JAX step's cast at entry; it
enters no autocast): a float32 activation meeting a rounded weight
computes in float32, as JAX promotes, and the gradients reach the
float32 parameters through the rounding.  Dropout draws from a
``torch.Generator`` the step owns on its device, seeded from `seed` (in
place of the JAX step's ``rng_guard`` key folded with the step count).
The learning rate is read before the update; an ``LRScheduler`` learning
rate is stepped after it, as the JAX step does.  What the JAX step
ignores raises at build: an optimizer's gradient clip, regularizer
object, ``apply_decay_param_fun`` or Lamb exclude function, and a
parameter's own regularizer or learning rate.
"""
import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..optimizer.lr import LRScheduler


class _LossView(nn.Module):
    """`loss_fn` over `model` as one module, so `functional_call` can
    swap the model's parameters for the rounded ones."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *batch, generator=None):
        return self.loss_fn(self.model, *batch, generator=generator)


class TrainStep:
    """``loss_fn(model, *batch, generator=...) -> scalar``; `optimizer` one
    of ``optimizer``'s update rules.  The model's parameters must lie on
    `device` (None means the card; without one it raises)."""

    def __init__(self, model, loss_fn, optimizer, amp_dtype=None, seed=0,
                 device=None):
        self.device = resolve_device(device, "TrainStep")
        optimizer.refuse_eager_only("TrainStep")
        self.model = model
        self.optimizer = optimizer
        self.amp_dtype = amp_dtype
        self.params = dict(model.named_parameters())
        for n, p in self.params.items():
            if p.device != self.device:
                raise ValueError(f"parameter {n} is on {p.device}, the step "
                                 f"on {self.device}")
            if getattr(p, "regularizer", None) is not None or getattr(
                    p, "optimize_attr", {}).get("learning_rate", 1.0) != 1.0:
                raise NotImplementedError(
                    f"parameter {n}: a per-parameter regularizer or "
                    f"learning rate is not ported to TrainStep (the JAX "
                    f"compiled step ignores both)")
        self.opt_state = {n: optimizer.init_state(p)
                          for n, p in self.params.items()}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._view = _LossView(model, loss_fn)
        self.step_count = 0

    def loss(self, *batch):
        """The loss at the current parameters, in float32, with autograd
        recording: the forward half of a step."""
        if self.amp_dtype is None:
            out = self._view(*batch, generator=self.generator)
        else:
            use = {f"model.{n}": p.to(self.amp_dtype)
                   if p.is_floating_point() and p.dim() > 1 else p
                   for n, p in self.params.items()}
            out = functional_call(self._view, use, batch,
                                  {"generator": self.generator})
        return out.float()

    def step(self, *batch):
        """One training step; returns the loss before the update (a 0-d
        float32 tensor on the device, not synchronised)."""
        batch = tuple(torch.as_tensor(b, device=self.device) for b in batch)
        for p in self.params.values():
            p.grad = None
        loss = self.loss(*batch)
        loss.backward()
        for p in self.params.values():
            if p.grad is None:      # off the loss's path: JAX's zero grad
                p.grad = torch.zeros_like(p)
        lr = self.optimizer.get_lr()
        with torch.no_grad():
            new_params, self.opt_state = self.optimizer.fused_update(
                {n: p.detach() for n, p in self.params.items()},
                {n: p.grad for n, p in self.params.items()},
                self.opt_state, lr)
            for n, p in self.params.items():
                p.copy_(new_params[n])
        if isinstance(self.optimizer.learning_rate, LRScheduler):
            self.optimizer.learning_rate.step()
        self.step_count += 1
        return loss.detach()
