"""Functional ops, layers and transformer layers of the training slice."""
from . import functional
from .layers import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                     Linear, ParallelCrossEntropy, RowParallelLinear, Tanh,
                     VocabParallelEmbedding)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ColumnParallelLinear", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MultiHeadAttention", "ParallelCrossEntropy",
           "RowParallelLinear", "Tanh", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer", "VocabParallelEmbedding",
           "functional"]
