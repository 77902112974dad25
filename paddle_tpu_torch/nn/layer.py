"""Parameters of the dygraph layers (``paddle_tpu/nn/layer.py``):
`ParamAttr` and `create_parameter`.

A parameter is a `ParamBase`, an ``nn.Parameter`` carrying the
attributes the eager optimizer step reads (``optimizer/optimizer.py::
Optimizer.step``):
``name``, ``optimize_attr = {"learning_rate": ...}``, ``regularizer``,
``need_clip`` and ``is_bias``; ``trainable`` is its ``requires_grad``.
An automatic name is ``param_{n}`` from a process-wide counter, as in
the JAX package, so names differ between runs and between the packages:
give ``ParamAttr(name=...)`` where a name must be known.
"""
import itertools

import torch
from torch import nn

from .initializer import Constant, XavierNormal

_param_counter = itertools.count(1)


def check_regularizer(reg, where):
    """`reg` if the eager step applies it as JAX does (None or an
    ``L2Decay``); ``L1Decay`` raises, since the JAX package reads its
    coefficient as an L2 one."""
    from ..optimizer.optimizer import L1Decay, L2Decay

    if reg is None or isinstance(reg, L2Decay):
        return reg
    if isinstance(reg, L1Decay):
        raise NotImplementedError(
            f"{where}: L1Decay is not ported (the JAX package applies its "
            f"coefficient as an L2 decay)")
    raise NotImplementedError(
        f"{where}: a regularizer must be an L2Decay, not "
        f"{type(reg).__name__}")


class ParamBase(nn.Parameter):
    """An ``nn.Parameter`` that carries the eager step's attributes
    (``torch.Tensor.name`` is read-only, so this class shadows it); a
    deep copy keeps them, as the JAX package's does."""

    name = None

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            copy = super().__deepcopy__(memo)
            copy.__dict__.update(self.__dict__)
        return memo[id(self)]


class ParamAttr:
    """The attributes `create_parameter` gives a parameter."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = check_regularizer(regularizer, "ParamAttr")
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, *, generator=None,
                     dtype=torch.float32):
    """A `ParamBase` of `shape` on the CPU, drawn from `generator` by
    `attr`'s initializer, else `default_initializer`, else zeros for a
    bias and XavierNormal for a weight; None where `attr` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    p = ParamBase(init(shape, dtype, generator, "cpu"),
                  requires_grad=attr.trainable)
    p.name = attr.name or f"param_{next(_param_counter)}"
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.is_bias = is_bias
    return p


def place(module, device):
    """`module` moved to `device`, where None means the card (a layer
    built without one raises when CUDA is missing, instead of staying on
    the CPU)."""
    from ..device import resolve_device

    return module.to(resolve_device(device, type(module).__name__))
