"""Layers GPT, BERT and ERNIE are built from (the JAX package's
``nn/layers/common.py``, ``nn/layers/norm.py``, ``nn/layers/activation.py``
and the single-card forms of ``distributed/fleet/meta_parallel/
mp_layers.py``).

Weights are drawn on the CPU from the `generator` each layer is given,
with the JAX package's distributions (XavierNormal for linears, Normal(0,
0.02) for the vocab embedding, Normal(0, 1) for a plain embedding, zeros
and ones for biases and LayerNorms), so one seed gives the same values
whatever device the model then moves to.  They are not the JAX package's
values: parity rests on weights carried across, not on equal random
streams."""
import math

import torch
from torch import nn

from . import functional as F


def _normal(shape, std, generator):
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class Linear(nn.Module):
    """``x @ weight + bias``, weight [in_features, out_features]."""

    def __init__(self, in_features, out_features, *, generator):
        super().__init__()
        std = math.sqrt(2.0 / (in_features + out_features))  # XavierNormal
        self.weight = _normal((in_features, out_features), std, generator)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ColumnParallelLinear(Linear):
    """Weight sharded on its columns over a model-parallel axis; at
    model-parallel degree 1, the only one ported, a plain linear."""


class RowParallelLinear(Linear):
    """Weight sharded on its rows, outputs summed over a model-parallel
    axis; at degree 1 a plain linear."""


class Embedding(nn.Module):
    """A [num_embeddings, embedding_dim] table, Normal(0, std)."""

    def __init__(self, num_embeddings, embedding_dim, *, generator,
                 std=1.0):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std,
                              generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class VocabParallelEmbedding(Embedding):
    """Table sharded on the vocabulary over a model-parallel axis; at
    degree 1 an embedding, Normal(0, 0.02)."""

    def __init__(self, num_embeddings, embedding_dim, *, generator):
        super().__init__(num_embeddings, embedding_dim, generator=generator,
                         std=0.02)


class ParallelCrossEntropy(nn.Module):
    """Vocabulary-sharded softmax cross entropy; at degree 1
    `softmax_with_cross_entropy`."""

    def forward(self, logits, label):
        return F.softmax_with_cross_entropy(logits, label)


class LayerNorm(nn.Module):
    """Normalises the last axis of `size`; weight ones, bias zeros."""

    def __init__(self, size, epsilon=1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout while training; draws its mask from
    the generator passed to each call."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        return F.dropout(x, self.p, training=self.training,
                         generator=generator)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
