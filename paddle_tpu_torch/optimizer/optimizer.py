"""The update rules of the compiled train step (``paddle_tpu/optimizer/
optimizer.py`` and ``parallel/hybrid.py::CompiledTrainStep`` at ZeRO
stage 0): SGD, Momentum, Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax
and Lamb.

Each rule is a pure update over tensors: ``update(param, grad, state,
lr)`` returns the new parameter and state, and `fused_update` applies it
to every parameter with the weight-decay convention: a coupled rule adds
``wd * p`` to the gradient, a decoupled one (AdamW) subtracts ``lr * wd *
p_old`` after the step; every parameter decays alike, LayerNorm weights
and biases included.  State tensors are float32 except Momentum's
velocity, which takes the parameter's dtype.  The learning rate is a
number or an ``lr.LRScheduler`` (`get_lr` reads ``sched()``; the train
step steps it after each update).  What the compiled step never applies
raises: gradient clipping, regularizer objects, ``apply_decay_param_fun``,
``lr_ratio`` and Lamb's ``exclude_from_weight_decay_fn``.  `minimize` of a
static loss appends the backward and one update op per parameter to its
program (``static/optimizer_bridge.py``); the eager ``minimize`` is not
ported yet."""
import numbers

import torch

from .lr import LRScheduler


class Optimizer:
    """The base of the rules: the learning rate, the weight-decay
    coefficient and `fused_update`."""

    decoupled_weight_decay = False

    def __init__(self, learning_rate=0.001, weight_decay=None,
                 grad_clip=None):
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise NotImplementedError(
                "learning_rate must be a number or an LRScheduler")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       numbers.Real):
            raise NotImplementedError(
                "weight_decay must be a number (regularizer objects are "
                "not ported)")
        self.learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self.weight_decay = float(weight_decay or 0.0)

    def get_lr(self):
        if isinstance(self.learning_rate, LRScheduler):
            return float(self.learning_rate())
        return self.learning_rate

    def init_state(self, param):
        return {}

    def update(self, param, grad, state, lr):
        """One step of one parameter, without weight decay."""
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """For a static `Variable` loss: append the backward and one
        update op per parameter to its program
        (``static.optimizer_bridge.static_minimize``)."""
        from ..static.optimizer_bridge import static_minimize
        from ..static.program import Variable

        if not isinstance(loss, Variable):
            raise NotImplementedError(
                "minimize of an eager loss is not ported yet: the port's "
                "optimizers run under TrainStep (fused_update) or a static "
                "program")
        return static_minimize(self, loss, startup_program, parameters,
                               no_grad_set)

    def fused_update(self, params, grads, states, lr):
        """`update` over dicts name -> tensor, with the weight-decay
        convention; a parameter without a gradient keeps its value and
        state."""
        wd = self.weight_decay
        new_params, new_states = {}, {}
        for n, p in params.items():
            g = grads.get(n)
            if g is None:
                new_params[n], new_states[n] = p, states[n]
                continue
            if wd and not self.decoupled_weight_decay:
                g = g + wd * p
            new_p, new_states[n] = self.update(p, g, states[n], lr)
            if wd and self.decoupled_weight_decay:
                new_p = new_p - lr * wd * p
            new_params[n] = new_p
        return new_params, new_states


def _zeros(param):
    return torch.zeros(param.shape, dtype=torch.float32, device=param.device)


def _one(param):
    return torch.ones((), dtype=torch.float32, device=param.device)


class SGD(Optimizer):
    def update(self, param, grad, state, lr):
        return param - lr * grad, state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, *,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, weight_decay, grad_clip)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def update(self, param, grad, state, lr):
        v = state["velocity"] * self.momentum + grad
        if self.use_nesterov:
            new_p = param - lr * (grad + self.momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    """Moments float32; ``beta1_pow`` and ``beta2_pow`` float32 scalars
    multiplied once per step; eps added to ``sqrt(vhat)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, *, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment1": _zeros(param), "moment2": _zeros(param),
                "beta1_pow": _one(param), "beta2_pow": _one(param)}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        g32 = grad.float()
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32.square()
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        step = lr * mhat / (vhat.sqrt() + eps)
        return param - step.to(param.dtype), {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    decoupled_weight_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, *, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "lr_ratio and apply_decay_param_fun are not ported: the "
                "compiled step decays every parameter at one rate")
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         weight_decay=weight_decay, grad_clip=grad_clip)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, *, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, weight_decay, grad_clip)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def init_state(self, param):
        return {"moment": torch.full(param.shape,
                                     self.initial_accumulator_value,
                                     dtype=torch.float32,
                                     device=param.device)}

    def update(self, param, grad, state, lr):
        g32 = grad.float()
        acc = state["moment"] + g32.square()
        step = lr * g32 / (acc.sqrt() + self.epsilon)
        return param - step.to(param.dtype), {"moment": acc}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, *, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, weight_decay, grad_clip)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def init_state(self, param):
        state = {"mean_square": _zeros(param), "momentum": _zeros(param)}
        if self.centered:
            state["mean_grad"] = _zeros(param)
        return state

    def update(self, param, grad, state, lr):
        rho, eps = self.rho, self.epsilon
        g32 = grad.float()
        ms = rho * state["mean_square"] + (1 - rho) * g32.square()
        new_state = {"mean_square": ms}
        if self.centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g32
            denom = (ms - mg.square() + eps).sqrt()
            new_state["mean_grad"] = mg
        else:
            denom = (ms + eps).sqrt()
        mom = self.momentum * state["momentum"] + lr * g32 / denom
        new_state["momentum"] = mom
        return param - mom.to(param.dtype), new_state


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, *,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, weight_decay, grad_clip)
        self.epsilon, self.rho = epsilon, rho

    def init_state(self, param):
        return {"avg_squared_grad": _zeros(param),
                "avg_squared_update": _zeros(param)}

    def update(self, param, grad, state, lr):
        rho, eps = self.rho, self.epsilon
        g32 = grad.float()
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g32.square()
        upd = (state["avg_squared_update"] + eps).sqrt() \
            / (asg + eps).sqrt() * g32
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd.square()
        return param - (lr * upd).to(param.dtype), {
            "avg_squared_grad": asg, "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, *, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment": _zeros(param), "inf_norm": _zeros(param),
                "beta1_pow": _one(param)}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        g32 = grad.float()
        m = b1 * state["moment"] + (1 - b1) * g32
        u = torch.maximum(b2 * state["inf_norm"], g32.abs())
        b1p = state["beta1_pow"] * b1
        step = lr / (1 - b1p) * m / (u + eps)
        return param - step.to(param.dtype), {
            "moment": m, "inf_norm": u, "beta1_pow": b1p}


class Lamb(Optimizer):
    """Layer-wise adaptive Adam: the Adam direction plus ``lamb_weight_decay
    * p``, scaled by the trust ratio ``||p|| / ||r||`` of each whole
    parameter (1 where either norm is 0).  Its decay lives in the rule,
    so `fused_update` adds none."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, *, grad_clip=None,
                 exclude_from_weight_decay_fn=None):
        if exclude_from_weight_decay_fn is not None:
            raise NotImplementedError(
                "exclude_from_weight_decay_fn is not ported: the compiled "
                "step never names the parameter it updates")
        super().__init__(learning_rate, None, grad_clip)
        self.lamb_weight_decay = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment1": _zeros(param), "moment2": _zeros(param),
                "beta1_pow": _one(param), "beta2_pow": _one(param)}

    def update(self, param, grad, state, lr):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        g32 = grad.float()
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32.square()
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        p32 = param.float()
        r = mhat / (vhat.sqrt() + eps) + self.lamb_weight_decay * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return param - (lr * trust * r).to(param.dtype), {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}
