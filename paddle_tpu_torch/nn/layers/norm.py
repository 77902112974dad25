"""Normalization layers (``paddle_tpu/nn/layers/norm.py``): LayerNorm,
batch norm and SyncBatchNorm, InstanceNorm1D/2D/3D, GroupNorm,
LocalResponseNorm and SpectralNorm.  A batch norm keeps its running
stats in the buffers ``_mean`` and ``_variance``, the JAX layer's names,
so both packages' ``state_dict`` keys match.  The layers with
parameters are built on `device`, where None means the card, as the
convolutions are; LayerNorm, a part of the transformer layers as Linear
and Embedding are, is built on the CPU (its model moves it)."""
import numpy as np
import torch
from torch import nn

from ...ops.nn_extra import spectral_sigma
from .. import functional as F
from ..initializer import Constant
from ..layer import create_parameter, place


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
                 use_global_stats=None, *, generator=None, device=None):
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
        place(self, device)

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


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics a data-parallel step would gather
    across its shards; an eager layer is `BatchNorm` (as the JAX layer
    is outside a sharded trace)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm below it (or itself) replaced by
        a SyncBatchNorm on the same device sharing its parameters and
        running stats."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class InstanceNorm2D(nn.Module):
    """`F.instance_norm` with a per-channel weight (ones) and bias
    (zeros), each dropped by ``*_attr=False``.  `momentum` and
    `data_format` are unused, as in the JAX layer, which also serves as
    InstanceNorm1D and InstanceNorm3D."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, generator=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = create_parameter(
            [num_features], weight_attr, default_initializer=Constant(1.0),
            generator=generator)
        self.bias = create_parameter([num_features], bias_attr,
                                     is_bias=True, generator=generator)
        place(self, device)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class GroupNorm(nn.Module):
    """`F.group_norm` with a per-channel weight (ones) and bias (zeros);
    `data_format` is unused, as in the JAX layer."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, generator=None, device=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self.weight = create_parameter(
            [num_channels], weight_attr, default_initializer=Constant(1.0),
            generator=generator)
        self.bias = create_parameter([num_channels], bias_attr,
                                     is_bias=True, generator=generator)
        place(self, device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias)


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(nn.Module):
    """``forward(weight)``: `weight` over its largest singular value by
    `power_iters` power-iteration steps from the parameters `weight_u`
    [weight_shape[dim]] and `weight_v` [the rest] (XavierNormal).  As in
    the JAX layer, they are parameters that the forward reads and never
    updates, and with ``power_iters=0`` sigma comes from them as they
    are."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, *, generator=None, device=None):
        super().__init__()
        self.dim, self.power_iters, self.epsilon = dim, power_iters, epsilon
        h = weight_shape[dim]
        self.weight_u = create_parameter([h], generator=generator)
        self.weight_v = create_parameter(
            [int(np.prod(weight_shape)) // h], generator=generator)
        place(self, device)

    def forward(self, weight):
        return weight / spectral_sigma(weight, self.dim, self.power_iters,
                                       self.epsilon, self.weight_u,
                                       self.weight_v)
