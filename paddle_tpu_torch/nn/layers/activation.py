"""Activation layers (``paddle_tpu/nn/layers/activation.py``), each over
its function in ``nn.functional``; `PReLU` holds its weight."""
from torch import nn

from .. import functional as F
from ..initializer import Constant
from ..layer import create_parameter


def _layer(fname, cls_name, **defaults):
    """A layer calling ``F.<fname>(x, **kwargs)``, its keyword arguments
    `defaults` overridden by those it is built with (positionally in
    their order)."""
    fn = getattr(F, fname)
    names = tuple(defaults)

    class _Act(nn.Module):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            if len(args) > len(names) or set(kwargs) - set(names):
                raise TypeError(f"{cls_name} takes {list(names)}")
            self.kwargs = {**defaults, **dict(zip(names, args)), **kwargs}

        def forward(self, x):
            return fn(x, **self.kwargs)

    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


ReLU = _layer("relu", "ReLU")
ReLU6 = _layer("relu6", "ReLU6")
Sigmoid = _layer("sigmoid", "Sigmoid")
LogSigmoid = _layer("log_sigmoid", "LogSigmoid")
Tanh = _layer("tanh", "Tanh")
Silu = _layer("silu", "Silu")
Swish = _layer("swish", "Swish")
Mish = _layer("mish", "Mish")
Softsign = _layer("softsign", "Softsign")
Tanhshrink = _layer("tanhshrink", "Tanhshrink")
Hardsigmoid = _layer("hardsigmoid", "Hardsigmoid")
Hardswish = _layer("hardswish", "Hardswish")
Softplus = _layer("softplus", "Softplus")
Selu = _layer("selu", "Selu")
GELU = _layer("gelu", "GELU", approximate=False)
LeakyReLU = _layer("leaky_relu", "LeakyReLU", negative_slope=0.01)
ELU = _layer("elu", "ELU", alpha=1.0)
Hardshrink = _layer("hardshrink", "Hardshrink", threshold=0.5)
Softshrink = _layer("softshrink", "Softshrink", threshold=0.5)
ThresholdedReLU = _layer("thresholded_relu", "ThresholdedReLU", threshold=1.0)
Softmax = _layer("softmax", "Softmax", axis=-1)
LogSoftmax = _layer("log_softmax", "LogSoftmax", axis=-1)
SELU = _layer("selu", "SELU", scale=1.0507009873554805,
             alpha=1.6732632423543772)
CELU = _layer("celu", "CELU", alpha=1.0)
GLU = _layer("glu", "GLU", axis=-1)


class Maxout(nn.Module):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class Hardtanh(nn.Module):
    """``clip(x, -1, 1)``: `min` and `max` are accepted and unused, as in
    the JAX layer."""

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardtanh(x)


class PReLU(nn.Module):
    """``x`` where ``x >= 0``, else ``weight x``: `num_parameters` weights
    (1, or one per channel), each `init`."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter([num_parameters], weight_attr,
                                       default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)
