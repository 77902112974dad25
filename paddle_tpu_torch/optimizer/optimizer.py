"""The optimizers (``paddle_tpu/optimizer/optimizer.py``): SGD, Momentum,
Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax and Lamb, each a pure
update rule ``update(param, grad, state, lr) -> (param, state)``, and
three paths that apply it:

- the eager `step` over the optimizer's ``parameters``, after
  ``loss.backward()``: JAX's ``Optimizer.step`` rule for rule, with
  gradient clipping (``nn.clip``), ``L2Decay`` at the optimizer or per
  parameter, each parameter's ``optimize_attr["learning_rate"]``,
  AdamW's ``apply_decay_param_fun`` and Lamb's
  ``exclude_from_weight_decay_fn``, and the lazy row update of a sparse
  gradient (``Embedding(sparse=True)``); `clear_grad`, `minimize`,
  `state_dict` and `set_state_dict`;
- `fused_update` over dicts of tensors, the compiled train step's
  (``parallel.TrainStep``);
- one update op per parameter of a static program (`minimize` of a
  static loss, ``static/optimizer_bridge.py``).

The weight-decay convention: a coupled rule adds ``wd * p`` to the
gradient, a decoupled one (AdamW) subtracts ``lr * wd * p_old`` after
the step.  State tensors are float32 except Momentum's velocity, which
takes the parameter's dtype.  The learning rate is a number or an
``lr.LRScheduler`` (`get_lr` reads ``sched()``).  The JAX compiled and
static paths never apply gradient clipping, regularizer objects,
``apply_decay_param_fun`` or Lamb's exclude function, so `TrainStep` and
static `minimize` refuse an optimizer that carries one
(`refuse_eager_only`); ``lr_ratio``, which no JAX code reads, a callable
learning rate and ``L1Decay``, which JAX applies as an L2 decay, raise
everywhere."""
import numbers

import numpy as np
import torch

from ..core.indexed_slices import coalesce
from .lr import LRScheduler


class L1Decay:
    """Refused wherever it is given: the JAX package reads its
    coefficient as an L2 one (no code applies ``coeff * sign(p)``)."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L2Decay:
    """Adds ``coeff * p`` to the gradient in the eager step."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class Optimizer:
    """The base of the rules: the learning rate, the weight decay, the
    eager step and `fused_update`."""

    decoupled_weight_decay = False
    apply_decay_param_fun = None
    # False for a rule that reads whole-parameter statistics (Lamb's
    # trust ratio): a sparse gradient then takes the dense update
    sparse_safe = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        from ..nn.layer import check_regularizer

        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise NotImplementedError(
                "learning_rate must be a number or an LRScheduler")
        if not isinstance(weight_decay, numbers.Real):
            check_regularizer(weight_decay, "weight_decay")
        self.learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self.regularization = weight_decay
        self.weight_decay = float(getattr(weight_decay, "_coeff",
                                          weight_decay) or 0.0)
        self._grad_clip = grad_clip
        self._states = {}           # id(parameter) -> its state
        self._global_step = 0
        self._current_param_name = None

    def get_lr(self):
        if isinstance(self.learning_rate, LRScheduler):
            return float(self.learning_rate())
        return self.learning_rate

    def set_lr(self, value):
        """Replace the learning rate (a scheduler too) by the number
        `value`."""
        self.learning_rate = float(value)

    def init_state(self, param):
        return {}

    def update(self, param, grad, state, lr):
        """One step of one parameter, without weight decay."""
        raise NotImplementedError

    def refuse_eager_only(self, who):
        """Raise NotImplementedError if this optimizer carries an option
        that only the eager step applies (the JAX compiled and static
        paths ignore them): `who` names the path that refuses."""
        found = [name for name, on in (
            ("grad_clip", self._grad_clip is not None),
            ("a regularizer object", isinstance(self.regularization,
                                                L2Decay)),
            ("apply_decay_param_fun", self.apply_decay_param_fun is not None),
            ("exclude_from_weight_decay_fn",
             getattr(self, "exclude_from_weight_decay_fn", None) is not None)
        ) if on]
        if found:
            raise NotImplementedError(
                f"{', '.join(found)} is not ported to {who}: only the eager "
                f"step applies it (the JAX compiled and static paths ignore "
                f"it)")

    # ---- the eager step ----
    def _state_for(self, p):
        st = self._states.get(id(p))
        if st is None:
            st = self._states[id(p)] = self.init_state(p.detach())
        return st

    def step(self):
        """One update of every parameter with a gradient that requires
        grad, in JAX's order: the step count, the learning rate read once;
        the sparse gradients' lazy updates (`_sparse_param_step`), unless
        a gradient clip makes them dense; the clip over the dense pairs,
        then each parameter's own update at ``lr *
        optimize_attr["learning_rate"]``.  A parameter without a gradient
        keeps its value and its state."""
        if self._parameter_list is None:
            raise ValueError("Optimizer created without parameters")
        self._global_step += 1
        lr = self.get_lr()
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None and p.requires_grad]
        sparse = [(p, g) for p, g in params_grads if g.is_sparse]
        params_grads = [(p, g) for p, g in params_grads if not g.is_sparse]
        with torch.no_grad():
            if self._grad_clip is not None:
                # a clip reads every gradient: the sparse ones densify
                params_grads += [(p, g.to_dense()) for p, g in sparse]
                sparse = []
            for p, g in sparse:
                self._sparse_param_step(p, g, lr * self._param_lr(p))
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            for p, g in params_grads:
                self._dense_param_step(p, g, lr * self._param_lr(p))

    @staticmethod
    def _param_lr(p):
        return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)

    def _decay_of(self, p):
        """The weight-decay coefficient of parameter `p`: its own
        regularizer's, else the optimizer's, 0 where
        `apply_decay_param_fun` says no."""
        wd = self.weight_decay
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            wd = float(reg._coeff)
        if self.apply_decay_param_fun is not None and p.name \
                and not self.apply_decay_param_fun(p.name):
            wd = 0.0
        return wd

    def _dense_param_step(self, p, g, plr):
        g = g.to(p.dtype)
        wd = self._decay_of(p)
        pv = p.detach()
        if wd and not self.decoupled_weight_decay:
            g = g + wd * pv
        self._current_param_name = p.name
        new_p, self._states[id(p)] = self.update(pv, g, self._state_for(p),
                                                 plr)
        if wd and self.decoupled_weight_decay:
            new_p = new_p - plr * wd * pv
        p.copy_(new_p)

    def _sparse_param_step(self, p, g, plr):
        """The lazy update of a sparse COO gradient `g`: its duplicate
        rows summed, then the rule over the touched rows of the parameter
        and of each parameter-shaped state tensor, with the decay of
        those rows; every other row stays as it was, bitwise.  Scalar
        state (Adam's beta powers) advances once a step.  A rule that is
        not `sparse_safe` takes the dense update."""
        if not self.sparse_safe:
            self._dense_param_step(p, g.to_dense(), plr)
            return
        ids, rows = coalesce(g)
        state = self._state_for(p)
        by_row = {k for k, v in state.items() if v.shape == p.shape}
        row_state = {k: v[ids] if k in by_row else v
                     for k, v in state.items()}
        cur = p.detach()[ids]
        rows = rows.to(p.dtype)
        wd = self._decay_of(p)
        if wd and not self.decoupled_weight_decay:
            rows = rows + wd * cur
        self._current_param_name = p.name
        new_rows, new_state = self.update(cur, rows, row_state, plr)
        if wd and self.decoupled_weight_decay:
            new_rows = new_rows - plr * wd * cur
        p.index_copy_(0, ids, new_rows)
        for k, v in new_state.items():
            if k in by_row:
                state[k].index_copy_(0, ids, v.to(state[k].dtype))
            else:
                state[k] = v

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """A static `Variable` loss: append the backward and one update
        op per parameter to its program
        (``static.optimizer_bridge.static_minimize``).  An eager loss:
        ``loss.backward()`` then `step`; returns (None, None)."""
        from ..static.program import Variable

        if isinstance(loss, Variable):
            from ..static.optimizer_bridge import static_minimize

            return static_minimize(self, loss, startup_program, parameters,
                                   no_grad_set)
        loss.backward()
        self.step()
        return None, None

    # ---- checkpoint ----
    def state_dict(self):
        """``global_step``, ``LR_Scheduler`` (for a scheduler) and each
        state tensor of a parameter that has state under both
        ``{name}_{key}`` and ``@pos{i}_{key}`` (one tensor): automatic
        names do not survive a restart, the parameters' order does."""
        out = {"global_step": self._global_step}
        if isinstance(self.learning_rate, LRScheduler):
            out["LR_Scheduler"] = self.learning_rate.state_dict()
        for i, p in enumerate(self._parameter_list or ()):
            for k, v in (self._states.get(id(p)) or {}).items():
                t = v.detach().clone()
                out[f"{p.name}_{k}"] = t
                out[f"@pos{i}_{k}"] = t
        return out

    def set_state_dict(self, state):
        """Load `state_dict`'s output: each state tensor by its name key
        first, then its positional key, skipping one whose shape
        differs."""
        self._global_step = int(state.get("global_step", 0))
        if isinstance(self.learning_rate, LRScheduler) \
                and "LR_Scheduler" in state:
            self.learning_rate.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list or ()):
            st = self._state_for(p)
            for k in list(st):
                for key in (f"{p.name}_{k}", f"@pos{i}_{k}"):
                    if key not in state:
                        continue
                    v = state[key]
                    v = (v.detach() if isinstance(v, torch.Tensor)
                         else torch.as_tensor(np.asarray(v)))
                    if v.dim() and tuple(v.shape) != tuple(st[k].shape):
                        continue
                    st[k] = v.to(device=st[k].device, dtype=st[k].dtype)
                    break

    # ---- the compiled step's path ----
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
                 parameters=None, use_nesterov=False, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip)
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
                 epsilon=1e-8, *, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip)
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
                 epsilon=1e-8, *, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "lr_ratio is not ported: no path of the JAX package reads "
                "it")
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         parameters=parameters, weight_decay=weight_decay,
                         grad_clip=grad_clip)
        self.apply_decay_param_fun = apply_decay_param_fun


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, *, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip)
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
                 centered=False, *, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip)
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
                 parameters=None, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip)
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
                 epsilon=1e-8, *, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip)
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
    so `fused_update` adds none; the eager step names the parameter it
    updates, so ``exclude_from_weight_decay_fn(name)`` True turns that
    parameter's decay off.  The trust ratio needs the whole parameter, so
    a sparse gradient takes the dense update."""

    sparse_safe = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, *, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self.exclude_from_weight_decay_fn = exclude_from_weight_decay_fn
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
        wd = self.lamb_weight_decay
        if self.exclude_from_weight_decay_fn is not None and \
                self.exclude_from_weight_decay_fn(
                    self._current_param_name or ""):
            wd = 0.0
        p32 = param.float()
        r = mhat / (vhat.sqrt() + eps) + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return param - (lr * trust * r).to(param.dtype), {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}
