"""Functional ops and layers of the training slice."""
from . import functional
from .layers import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                     Linear, ParallelCrossEntropy, RowParallelLinear,
                     VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "Dropout", "Embedding", "LayerNorm",
           "Linear", "ParallelCrossEntropy", "RowParallelLinear",
           "VocabParallelEmbedding", "functional"]
