"""Weights carried between the packages as numpy arrays, under the JAX
models' ``named_parameters()`` or ``state_dict()`` names, and static
scopes carried as ``{var name: numpy array}``."""
import numpy as np
import torch

from ..device import resolve_device
from ..static.executor import Scope


def scope_from_numpy(arrays, device=None):
    """A `Scope` on `device` (None means the card) holding `arrays`,
    ``{name: numpy array}``: for example a JAX static scope's
    ``{n: np.asarray(scope.get(n))}``, so both executors train from the
    same parameters, optimizer state and running stats."""
    dev = resolve_device(device, "scope_from_numpy")
    scope = Scope()
    for name, value in arrays.items():
        scope.set(name, torch.as_tensor(np.array(value)).to(dev))
    return scope


def scope_to_numpy(scope):
    """``{name: numpy array}`` of every value in `scope`: the inverse of
    `scope_from_numpy`."""
    return {n: scope.get(n).detach().cpu().numpy() for n in scope.names()
            if scope.get(n) is not None}


def layer_from_numpy(module, named, device=None):
    """`module` holding `named`, moved to `device` (None means the card):
    a JAX layer's ``state_dict()`` as numpy arrays, parameters and batch
    norms' running stats alike (linear weights [in, out] in both
    packages).  A missing or unknown name, or a shape that differs,
    raises ValueError."""
    dev = resolve_device(device, type(module).__name__)
    own = module.state_dict(keep_vars=True)
    if set(named) != set(own):
        raise ValueError(f"state names differ: missing "
                         f"{sorted(set(own) - set(named))}, unknown "
                         f"{sorted(set(named) - set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            value = torch.as_tensor(np.array(named[name]))
            if value.shape != t.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(value)
    return module.to(dev)


def layer_to_numpy(module):
    """``{name: numpy array}`` of `module`'s ``state_dict()``, copies that
    later steps leave alone: the inverse of `layer_from_numpy`."""
    return {n: t.detach().cpu().numpy().copy()
            for n, t in module.state_dict().items()}


class NumpyWeights:
    """`from_numpy_params` and `numpy_params` for a model class built as
    ``cls(config, ..., device=...)``."""

    @classmethod
    def from_numpy_params(cls, named, config, device=None, **kwargs):
        """A model on `device` (None means the card) holding `named`: the
        JAX model's ``named_parameters()`` as numpy arrays, linear weights
        [in, out]; `kwargs` go to the constructor.  A missing or unknown
        name, or a shape that differs, raises ValueError."""
        dev = resolve_device(device, cls.__name__)
        model = cls(config, device="cpu", **kwargs)
        params = dict(model.named_parameters())
        if set(named) != set(params):
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(set(params) - set(named))}, "
                             f"unknown {sorted(set(named) - set(params))}")
        with torch.no_grad():
            for name, p in params.items():
                value = torch.as_tensor(np.array(named[name]))
                if value.shape != p.shape:
                    raise ValueError(f"{name}: shape {tuple(value.shape)} "
                                     f"!= {tuple(p.shape)}")
                p.copy_(value)
        return model.to(dev)

    def numpy_params(self):
        """``{name: numpy array}`` of every parameter: the inverse of
        `from_numpy_params`."""
        return {n: p.detach().cpu().numpy()
                for n, p in self.named_parameters()}
