"""The dygraph layers (convolutions, pools, norms, pads and resamplers,
the transformer, the recurrent nets and beam-search decoding,
activations, containers and losses), their functional ops, parameters
and initializers, weight and spectral normalization, and gradient
clipping."""
from . import functional, initializer, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   utils_clip_grad_norm_)
from .layer import ParamAttr, create_parameter
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .utils import spectral_norm

__all__ = sorted(_layers + [
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
    "MultiHeadAttention", "ParamAttr", "Transformer", "TransformerDecoder",
    "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "create_parameter", "functional",
    "initializer", "spectral_norm", "utils", "utils_clip_grad_norm_"])
