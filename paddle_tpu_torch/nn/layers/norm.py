"""Normalization layers (``paddle_tpu/nn/layers/norm.py``): LayerNorm
and batch norm.  A batch norm keeps its running stats in the buffers
``_mean`` and ``_variance``, the JAX layer's names, so both packages'
``state_dict`` keys match."""
import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant
from ..layer import create_parameter


class LayerNorm(nn.Module):
    """Normalises the last axis of `size`; weight ones, bias zeros."""

    def __init__(self, size, epsilon=1e-5, weight_attr=None, bias_attr=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = create_parameter([size], weight_attr,
                                       default_initializer=Constant(1.0))
        self.bias = create_parameter([size], bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class _BatchNormBase(nn.Module):
    """`F.batch_norm` over axis 1 with momentum 0.9 by default: batch
    statistics (biased variance) while training, the running stats in
    eval mode or with `use_global_stats`."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, *, generator=None):
        super().__init__()
        if data_format not in ("NC", "NCL", "NCHW", "NCDHW"):
            raise NotImplementedError(
                f"data_format={data_format!r} is not ported: channels "
                f"first only")
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = create_parameter(
            [num_features], weight_attr, default_initializer=Constant(1.0),
            generator=generator)
        self.bias = create_parameter([num_features], bias_attr,
                                     is_bias=True, generator=generator)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """The fluid-style name, the same layer."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass
