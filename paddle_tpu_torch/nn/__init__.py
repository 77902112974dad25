"""The dygraph layers (conv nets and the transformer), their functional
ops, parameters and initializers, and gradient clipping."""
from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   utils_clip_grad_norm_)
from .layer import ParamAttr, create_parameter
from .layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                     BatchNorm2D, BatchNorm3D, ColumnParallelLinear, Conv2D,
                     Dropout, Embedding, Flatten, LayerList, LayerNorm,
                     Linear, MaxPool2D, ParallelCrossEntropy, ReLU, ReLU6,
                     RowParallelLinear, Sequential, Tanh,
                     VocabParallelEmbedding)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "ColumnParallelLinear",
           "Conv2D", "Dropout", "Embedding", "Flatten", "LayerList",
           "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention",
           "ParallelCrossEntropy", "ParamAttr", "ReLU", "ReLU6",
           "RowParallelLinear", "Sequential", "Tanh", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "VocabParallelEmbedding", "create_parameter", "functional",
           "initializer", "utils_clip_grad_norm_"]
