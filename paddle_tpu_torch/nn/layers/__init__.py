"""The dygraph layers, one module per file of the JAX package's
``nn/layers/``."""
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink,
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, Selu, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (ColumnParallelLinear, Dropout, Embedding, Flatten,
                     Linear, ParallelCrossEntropy, RowParallelLinear,
                     VocabParallelEmbedding)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .decode import BeamSearchDecoder, dynamic_decode
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
                   PairwiseDistance, SmoothL1Loss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)

ACTIVATIONS = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
               "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid",
               "LogSoftmax", "Maxout", "Mish", "PReLU", "ReLU", "ReLU6",
               "SELU", "Selu", "Sigmoid", "Silu", "Softmax", "Softplus",
               "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
               "ThresholdedReLU"]
LOSSES = ["BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "KLDivLoss",
          "L1Loss", "MSELoss", "MarginRankingLoss", "NLLLoss",
          "PairwiseDistance", "SmoothL1Loss"]
RECURRENT = ["BeamSearchDecoder", "BiRNN", "GRU", "GRUCell", "LSTM",
             "LSTMCell", "RNN", "RNNCellBase", "SimpleRNN", "SimpleRNNCell",
             "dynamic_decode"]

__all__ = ACTIVATIONS + LOSSES + RECURRENT + [
    "AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
    "BatchNorm2D", "BatchNorm3D", "ColumnParallelLinear", "Conv2D",
    "Dropout", "Embedding", "Flatten", "LayerDict", "LayerList",
    "LayerNorm", "Linear", "MaxPool2D", "ParallelCrossEntropy",
    "ParameterList", "RowParallelLinear", "Sequential",
    "VocabParallelEmbedding"]
