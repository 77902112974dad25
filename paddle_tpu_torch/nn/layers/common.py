"""Common layers (``paddle_tpu/nn/layers/common.py``): Linear, Embedding,
Dropout and Flatten, and the tensor-parallel layers of
``distributed/fleet/meta_parallel/mp_layers.py`` (ColumnParallelLinear,
RowParallelLinear, VocabParallelEmbedding, ParallelCrossEntropy),
re-exported here.

Weights come from `create_parameter` with the JAX package's defaults
(XavierNormal for linears, Normal(0, 0.02) for the vocab embedding,
Normal(0, 1) for a plain embedding, zeros for biases), drawn on the CPU
from the `generator` each layer is given, so one seed gives the same
values whatever device the model then moves to."""
import torch
from torch import nn

from .. import functional as F
from ..initializer import Normal, XavierNormal
from ..layer import create_parameter


class Linear(nn.Module):
    """``x @ weight + bias``, weight [in_features, out_features];
    ``bias_attr=False`` means no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, *, generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=XavierNormal(), generator=generator)
        self.bias = create_parameter([out_features], bias_attr, is_bias=True,
                                     generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """A [num_embeddings, embedding_dim] table, Normal(0, std).  A
    `padding_idx` (negative: counted from the end) has its row zeroed
    here and its lookups masked to zeros, so the row gets no gradient.
    Sparse gradients (``sparse=True``) raise."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, *, generator=None,
                 std=1.0):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True) is not ported: its gradient is "
                "dense")
        self._padding_idx = (None if padding_idx is None
                             else padding_idx if padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=Normal(0.0, std), generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout while training.  The mask draws from
    the generator passed to the call, else, where the layer was given a
    `seed`, from a generator of its own on the input's device seeded
    with it."""

    def __init__(self, p=0.5, *, seed=None):
        super().__init__()
        self.p = p
        self.seed = seed
        self._generator = None

    def forward(self, x, generator=None):
        if generator is None and self.seed is not None and self.training:
            if self._generator is None or \
                    self._generator.device != x.device:
                self._generator = torch.Generator(device=x.device)
                self._generator.manual_seed(self.seed)
            generator = self._generator
        return F.dropout(x, self.p, training=self.training,
                         generator=generator)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


# the tensor-parallel layers subclass Linear and Embedding above
from ...distributed.fleet.meta_parallel.mp_layers import (  # noqa: E402
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
