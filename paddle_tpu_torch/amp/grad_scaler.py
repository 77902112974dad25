"""Loss scaling (``paddle_tpu/amp/grad_scaler.py``): `AmpScaler` and
`GradScaler`.

`unscale_` multiplies every gradient of the optimizer's parameters by
1/scale and reduces "any of them not finite" to one flag on the device,
read once per step (the JAX package reads one per parameter; the skip
and the update are the same).  `step` skips the optimizer's step when
the flag is set, leaving the parameters, the optimizer's state and its
step count as they were; the LR scheduler is the caller's to step, as
in JAX.  `update` is the dynamic rule of ``update_loss_scaling``.  As in
JAX, `step` unscales whatever `unscale_` already did: call one or the
other."""
import torch


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        """`var` times the scale (a Python number: a bfloat16 loss stays
        bfloat16, as in JAX)."""
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        flags = []
        with torch.no_grad():
            for p in optimizer._parameter_list or ():
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise NotImplementedError(
                        "sparse gradients are not ported (Embedding("
                        "sparse=True) is refused)")
                p.grad = p.grad * inv
                flags.append((~torch.isfinite(p.grad)).any())
        self._found_inf = bool(torch.stack(flags).any()) if flags else False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        """The dynamic loss-scale update (``update_loss_scaling``): after
        `decr_every_n_nan_or_inf` steps with a non-finite gradient the
        scale falls by `decr_ratio` (not below 1), after
        `incr_every_n_steps` finite ones in a row it grows by
        `incr_ratio`."""
        if not (self._enable and self._use_dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        """The scale and the step counts of `state_dict`'s output (the
        JAX scaler's too); the ratios stay the constructor's, as in
        JAX."""
        self._scale = float(state.get("scale", self._scale))
        self._good_steps = int(state.get("good_steps", 0))
        self._bad_steps = int(state.get("bad_steps", 0))


class GradScaler(AmpScaler):
    """The public name (``paddle.amp.GradScaler``)."""
