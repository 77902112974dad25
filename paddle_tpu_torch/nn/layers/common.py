"""Common layers (``paddle_tpu/nn/layers/common.py``): Linear, Embedding,
the dropouts (Dropout, Dropout2D, Dropout3D, AlphaDropout), Flatten,
Identity, the pads (Pad1D, Pad2D, Pad3D, ZeroPad2D), the resamplers
(Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, PixelShuffle),
CosineSimilarity, Bilinear, Unfold and Fold, and the tensor-parallel
layers of
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
from ..layer import create_parameter, place


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
    With ``sparse=True`` the weight's eager gradient is a sparse COO
    tensor of the looked-up rows (`F.embedding`), which the optimizers'
    eager step applies to those rows alone."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, *, generator=None,
                 std=1.0):
        super().__init__()
        self._sparse = sparse
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
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


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

    def _draw(self, x, generator):
        if generator is None and self.seed is not None and self.training:
            if self._generator is None or \
                    self._generator.device != x.device:
                self._generator = torch.Generator(device=x.device)
                self._generator.manual_seed(self.seed)
            generator = self._generator
        return generator

    def forward(self, x, generator=None):
        return F.dropout(x, self.p, training=self.training,
                         generator=self._draw(x, generator))


class Dropout2D(Dropout):
    """`F.dropout2d` of whole channels, drawing as `Dropout` does."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *, seed=None):
        super().__init__(p, seed=seed)
        self.data_format = data_format

    def forward(self, x, generator=None):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self._draw(x, generator))


class Dropout3D(Dropout):
    """`F.dropout3d` of whole channel volumes, drawing as `Dropout`
    does."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None, *, seed=None):
        super().__init__(p, seed=seed)
        self.data_format = data_format

    def forward(self, x, generator=None):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self._draw(x, generator))


class AlphaDropout(Dropout):
    """`F.alpha_dropout`, drawing as `Dropout` does."""

    def __init__(self, p=0.5, name=None, *, seed=None):
        super().__init__(p, seed=seed)

    def forward(self, x, generator=None):
        return F.alpha_dropout(x, self.p, training=self.training,
                               generator=self._draw(x, generator))


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _Pad(nn.Module):
    """`F.pad` of the spatial axes, `padding` in paddle's order (the last
    axis's pair first); an int is repeated over the axes, except in
    Pad1D, whose JAX layer takes a list only."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", repeat=None):
        super().__init__()
        if isinstance(padding, int) and repeat:
            padding = [padding] * repeat
        self.padding, self.mode, self.value = padding, mode, value
        self.df = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.df)


class Pad1D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, repeat=4)


class Pad3D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, repeat=6)


class ZeroPad2D(_Pad):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format, repeat=4)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners, self.df = mode, align_corners, \
            data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.df)


class UpsamplingBilinear2D(nn.Module):
    """Bilinear with `align_corners`; `data_format` is unused, as in the
    JAX layer."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor,
                             mode="bilinear", align_corners=True)


class UpsamplingNearest2D(nn.Module):
    """`data_format` is unused, as in the JAX layer."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode="nearest")


class PixelShuffle(nn.Module):
    """`data_format` is unused, as in the JAX layer."""

    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.r)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(nn.Module):
    """``x1 W_o x2 + b``: weight [out, in1, in2] (XavierNormal), bias [1,
    out] (zeros); built on `device`, where None means the card."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 generator=None, device=None):
        super().__init__()
        self.weight = create_parameter(
            [out_features, in1_features, in2_features], weight_attr,
            generator=generator)
        self.bias = create_parameter([1, out_features], bias_attr,
                                     is_bias=True, generator=generator)
        place(self, device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.k, self.s, self.p, self.d = (kernel_sizes, strides, paddings,
                                          dilations)

    def forward(self, x):
        return F.unfold(x, self.k, strides=self.s, paddings=self.p,
                        dilations=self.d)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.o, self.k, self.s, self.p, self.d = (
            output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.o, self.k, strides=self.s, paddings=self.p,
                      dilations=self.d)


# the tensor-parallel layers subclass Linear and Embedding above
from ...distributed.fleet.meta_parallel.mp_layers import (  # noqa: E402
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
