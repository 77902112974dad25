"""Weight and spectral normalization as forward pre-hooks
(``paddle_tpu/nn/utils.py``): before every call the layer's weight is
recomputed from its reparameterised pieces, which are its parameters."""
import torch

from ..ops.nn_extra import spectral_norm_apply

__all__ = ["WeightNorm", "SpectralNorm", "remove_weight_norm",
           "spectral_norm", "weight_norm"]


def _norm_except_dim(w, dim):
    """L2 norm over every axis but `dim` (-1: over all, as [1])."""
    if dim == -1:
        return torch.sqrt(torch.sum(w * w)).reshape(1)
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(w * w, dim=axes))


def _parameter(layer, value, like):
    """A parameter of `layer`'s kind holding `value` (`like`'s
    attributes: trainable, learning rate, regularizer)."""
    from .layer import ParamBase

    p = ParamBase(value.detach().clone(), requires_grad=like.requires_grad)
    for attr in ("optimize_attr", "regularizer", "need_clip", "is_bias"):
        if hasattr(like, attr):
            setattr(p, attr, getattr(like, attr))
    return p


class WeightNorm:
    """The hook of `weight_norm`: ``name = g v / ||v||`` over every axis
    but `dim` (-1: over all)."""

    def __init__(self, name, dim):
        self.name, self.dim = name, dim

    def compute_weight(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        n = torch.clamp(_norm_except_dim(v, self.dim), min=1e-12)
        shape = [1] * v.dim()
        if self.dim != -1:
            shape[self.dim] = -1
        return v * (g / n).reshape(shape)

    @staticmethod
    def apply(layer, name, dim):
        for hook in layer._forward_pre_hooks.values():
            if isinstance(hook, WeightNorm) and hook.name == name:
                raise RuntimeError(f"weight_norm already registered on "
                                   f"{name}")
        w = layer._parameters[name]
        rank = w.dim()
        if dim is None:
            dim = -1
        if not -rank <= dim < rank:
            raise ValueError(f"dim {dim} out of range for rank {rank}")
        if dim != -1:
            dim = dim % rank
        fn = WeightNorm(name, dim)
        del layer._parameters[name]
        layer.register_parameter(name + "_v", _parameter(layer, w, w))
        layer.register_parameter(name + "_g", _parameter(
            layer, _norm_except_dim(w.detach(), dim), w))
        with torch.no_grad():  # a leaf until the first call: it copies
            object.__setattr__(layer, name, fn.compute_weight(layer))
        fn.handle = layer.register_forward_pre_hook(fn)
        return fn

    def remove(self, layer):
        with torch.no_grad():
            w = self.compute_weight(layer)
        like = getattr(layer, self.name + "_v")
        del layer._parameters[self.name + "_g"]
        del layer._parameters[self.name + "_v"]
        object.__delattr__(layer, self.name)
        layer.register_parameter(self.name, _parameter(layer, w, like))

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute_weight(layer))


def weight_norm(layer, name="weight", dim=0):
    """Replace ``layer.<name>`` by ``g v / ||v||``, recomputed before each
    call from the new parameters ``<name>_g`` and ``<name>_v``."""
    WeightNorm.apply(layer, name, dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold the current normalized weight back into one parameter and
    remove the hook."""
    for hook in list(layer._forward_pre_hooks.values()):
        if isinstance(hook, WeightNorm) and hook.name == name:
            hook.remove(layer)
            hook.handle.remove()
            return layer
    raise ValueError(f"weight_norm of '{name}' not found in {layer}")


class SpectralNorm:
    """The hook of `spectral_norm`: ``name = spectral_norm_apply(
    <name>_orig)`` before each call."""

    def __init__(self, name, n_power_iterations, eps, dim):
        self.name = name
        self.n_power_iterations, self.eps, self.dim = (n_power_iterations,
                                                       eps, dim)

    def compute_weight(self, layer):
        return spectral_norm_apply(getattr(layer, self.name + "_orig"),
                                   self.n_power_iterations, self.eps,
                                   self.dim)

    @staticmethod
    def apply(layer, name, n_power_iterations, eps, dim):
        fn = SpectralNorm(name, n_power_iterations, eps, dim)
        w = layer._parameters.pop(name)
        layer.register_parameter(name + "_orig", w)
        with torch.no_grad():
            object.__setattr__(layer, name, fn.compute_weight(layer))
        layer.register_forward_pre_hook(fn)
        return fn

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute_weight(layer))


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value, estimated by
    power iteration before each call; `dim` None is 1 for a Linear or a
    transposed convolution (their out axis), else 0."""
    if dim is None:
        from .layers.common import Linear
        from .layers.conv import (Conv1DTranspose, Conv2DTranspose,
                                  Conv3DTranspose)

        dim = 1 if isinstance(layer, (Linear, Conv1DTranspose,
                                      Conv2DTranspose,
                                      Conv3DTranspose)) else 0
    SpectralNorm.apply(layer, name, n_power_iterations, eps, dim)
    return layer
