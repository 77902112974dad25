"""The dygraph layers, one module per file of the JAX package's
``nn/layers/``."""
from .activation import ReLU, ReLU6, Tanh
from .common import (ColumnParallelLinear, Dropout, Embedding, Flatten,
                     Linear, ParallelCrossEntropy, RowParallelLinear,
                     VocabParallelEmbedding)
from .container import LayerList, Sequential
from .conv import Conv2D
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "ColumnParallelLinear", "Conv2D",
           "Dropout", "Embedding", "Flatten", "LayerList", "LayerNorm",
           "Linear", "MaxPool2D", "ParallelCrossEntropy", "ReLU", "ReLU6",
           "RowParallelLinear", "Sequential", "Tanh",
           "VocabParallelEmbedding"]
