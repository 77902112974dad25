"""Adam and AdamW with the compiled train step's conventions
(``paddle_tpu/optimizer/optimizer.py`` ``Adam.update``, ``fused_update``
and ``parallel/hybrid.py::make_fused_update``).

A pure update over tensors: ``update(param, grad, state, lr)`` returns
the new parameter and state.  Moments are float32; ``beta1_pow`` and
``beta2_pow`` are float32 scalars multiplied once per step; eps is added
to ``sqrt(vhat)``.  Weight decay applies to every parameter, LayerNorm
weights and biases included: AdamW (decoupled) subtracts ``lr * wd *
p_old`` after the Adam step, Adam (coupled) adds ``wd * p`` to the
gradient.  LR schedulers, gradient clipping, ``apply_decay_param_fun``
and ``lr_ratio`` are not ported and raise."""
import numbers

import torch


class Adam:
    decoupled_weight_decay = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "only a constant learning rate is ported: LR schedulers "
                "are not yet")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       numbers.Real):
            raise NotImplementedError(
                "weight_decay must be a number (regularizer objects are "
                "not ported)")
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = float(weight_decay or 0.0)

    def get_lr(self):
        return self.learning_rate

    def init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32,
                        device=param.device)
        one = torch.ones((), dtype=torch.float32, device=param.device)
        return {"moment1": z, "moment2": z.clone(), "beta1_pow": one,
                "beta2_pow": one.clone()}

    def update(self, param, grad, state, lr):
        """One Adam step of one parameter, without weight decay."""
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


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    decoupled_weight_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "lr_ratio and apply_decay_param_fun are not ported: the "
                "compiled step decays every parameter at one rate")
        super().__init__(learning_rate, beta1, beta2, epsilon, weight_decay,
                         grad_clip)
