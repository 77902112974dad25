"""The dygraph layers, one module per file of the JAX package's
``nn/layers/``."""
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink,
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, Selu, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, ColumnParallelLinear,
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, Flatten, Fold, Identity, Linear, Pad1D,
                     Pad2D, Pad3D, ParallelCrossEntropy, PixelShuffle,
                     RowParallelLinear, Unfold, Upsample,
                     UpsamplingBilinear2D, UpsamplingNearest2D,
                     VocabParallelEmbedding, ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                   Conv3D, Conv3DTranspose)
from .decode import BeamSearchDecoder, dynamic_decode
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, CTCLoss,
                   HSigmoidLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, NLLLoss, PairwiseDistance, SmoothL1Loss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)

ACTIVATIONS = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
               "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid",
               "LogSoftmax", "Maxout", "Mish", "PReLU", "ReLU", "ReLU6",
               "SELU", "Selu", "Sigmoid", "Silu", "Softmax", "Softplus",
               "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
               "ThresholdedReLU"]
LOSSES = ["BCELoss", "BCEWithLogitsLoss", "CTCLoss", "CrossEntropyLoss",
          "HSigmoidLoss", "KLDivLoss", "L1Loss", "MSELoss",
          "MarginRankingLoss", "NLLLoss", "PairwiseDistance", "SmoothL1Loss"]
CONV_POOL = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
             "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
             "AvgPool1D", "AvgPool2D", "AvgPool3D", "Conv1D",
             "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
             "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D"]
NORMS = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
         "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
         "LayerNorm", "LocalResponseNorm", "SpectralNorm", "SyncBatchNorm"]
COMMON = ["AlphaDropout", "Bilinear", "CosineSimilarity", "Dropout",
          "Dropout2D", "Dropout3D", "Embedding", "Flatten", "Fold",
          "Identity", "Linear", "Pad1D", "Pad2D", "Pad3D", "PixelShuffle",
          "Unfold", "Upsample", "UpsamplingBilinear2D",
          "UpsamplingNearest2D", "ZeroPad2D"]
RECURRENT = ["BeamSearchDecoder", "BiRNN", "GRU", "GRUCell", "LSTM",
             "LSTMCell", "RNN", "RNNCellBase", "SimpleRNN", "SimpleRNNCell",
             "dynamic_decode"]

__all__ = ACTIVATIONS + LOSSES + RECURRENT + CONV_POOL + NORMS + COMMON + [
    "ColumnParallelLinear", "LayerDict", "LayerList",
    "ParallelCrossEntropy", "ParameterList", "RowParallelLinear",
    "Sequential", "VocabParallelEmbedding"]
