"""The functional namespace (``paddle_tpu/nn/functional.py``): the
activation, softmax and dropout functions, the convolutions, pools,
instance and group norms and resampling of ``ops.nn_ops``, the losses
of ``ops.loss``, ``ops.nn_extra``'s 1-D and 3-D convolutions and pools,
sampling grids, layer losses and the rest, `label_smooth`,
`diag_embed`, `sequence_mask` and the in-place aliases; and the layers'
own functions (`linear`, `layer_norm`, `embedding`, `batch_norm`).  Mixed
dtypes promote as JAX promotes them: a bfloat16 operand meeting a
float32 one computes in float32.  Under dygraph AMP (``amp.auto_cast``)
`linear`, `matmul` and the convolutions first cast their float32
tensors as the JAX ops ``linear``/``linear_nobias``, ``matmul_v2``,
``conv1d``, ``conv2d`` and ``conv2d_transpose`` are cast."""
import torch

from ..amp.auto_cast import cast_inputs
from ..core.indexed_slices import indexed_slices
from ..ops.loss import (IGNORE_INDEX, binary_cross_entropy,  # noqa: F401
                        binary_cross_entropy_with_logits, cosine_similarity,
                        cross_entropy, hinge_loss, kl_div, l1_loss,
                        margin_ranking_loss, mse_loss, nll_loss,
                        sigmoid_focal_loss, smooth_l1_loss,
                        softmax_with_cross_entropy, square_error_cost)
from ..ops.manipulation import flatten, one_hot, pad  # noqa: F401
from ..ops.math import matmul, matmul_promoted, tanh  # noqa: F401
from ..ops.nn_extra import (celu, gather_tree,  # noqa: F401
                            pairwise_distance)
from ..ops.nn_extra import (adaptive_avg_pool1d,  # noqa: F401
                            adaptive_avg_pool3d, adaptive_max_pool1d,
                            adaptive_max_pool3d, affine_grid, avg_pool3d,
                            bilinear, conv1d_transpose, conv3d,
                            conv3d_transpose, ctc_loss, dice_loss, dropout3d,
                            fold, grid_sample, hsigmoid_loss, log_loss,
                            max_pool3d, npair_loss, temporal_shift)
from ..ops.nn_ops import _affine
from ..ops.nn_ops import (adaptive_avg_pool2d,  # noqa: F401
                          adaptive_max_pool2d, alpha_dropout, avg_pool1d,
                          avg_pool2d, conv1d, conv2d, conv2d_transpose,
                          dropout, dropout2d, elu, gelu, glu, group_norm,
                          hardshrink, hardsigmoid, hardswish, hardtanh,
                          instance_norm, interpolate, leaky_relu,
                          local_response_norm, log_sigmoid, log_softmax,
                          max_pool1d, max_pool2d, maxout, mish, normalize,
                          pixel_shuffle, prelu, relu, relu6, selu, sigmoid,
                          silu, softmax, softplus, softshrink, softsign,
                          swish, tanhshrink, thresholded_relu, unfold,
                          upsample)


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with weight [in, out], in the promoted dtype
    of x and weight (float32 x and bfloat16 weight: float32).  Under AMP
    x, weight and bias are cast (the JAX ``linear`` op, or
    ``linear_nobias`` without a bias)."""
    if bias is None:
        x, weight = cast_inputs("linear_nobias", x, weight)
    else:
        x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = matmul_promoted(x, weight)
    return out if bias is None else out + bias


def layer_norm(x, weight, bias, epsilon=1e-5):
    """Normalise over the last axis: mean, centred variance,
    ``(x - mean) * rsqrt(var + epsilon)``, then weight and bias (which
    promote a bfloat16 x to their float32)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + epsilon) * weight + bias


class _SparseLookup(torch.autograd.Function):
    """Rows of a weight at integer ids whose weight gradient is a sparse
    COO tensor of one row per lookup, in lookup order
    (``core.indexed_slices``).  PyTorch's own sparse embedding drops a
    padding index's rows from its gradient; this one keeps them (as
    zeros, the caller masks the output), as JAX's ``IndexedSlices``
    does."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.dense_shape = tuple(weight.shape)
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, cot):
        ids, = ctx.saved_tensors
        return indexed_slices(ids, cot, ctx.dense_shape), None


def embedding(ids, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [num, dim] at integer `ids`; a lookup of a
    `padding_idx` >= 0 gives zeros, and so no gradient to that row (a
    negative one masks nothing, as in the JAX package: the layer counts
    it from the end first).  With `sparse`, where autograd records the
    lookup, the weight's gradient is a sparse COO tensor of one row per
    lookup (a padding lookup's row zero) instead of a dense [num, dim]
    one.  The compiled steps (``parallel.CompiledTrainStep``,
    ``PipelinedTrainStep``) densify it, as JAX's gradient is dense under
    tracing, and the static graph's ``lookup_table_v2`` is a dense op of
    its own."""
    ids = ids.long()
    if sparse and torch.is_grad_enabled() and weight.requires_grad:
        out = _SparseLookup.apply(weight, ids)
    else:
        out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def batch_stats(x, axes):
    """Mean and biased variance ``E[x²] − mean²`` over `axes`, the
    arithmetic of ``ops/nn_ops.py::batch_norm`` (PyTorch's batch norm
    uses Welford's variance and keeps the unbiased one)."""
    mean = x.mean(dim=axes)
    return mean, x.square().mean(dim=axes) - mean.square()


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm over every axis but 1.  In training (unless
    `use_global_stats`) it normalises by the batch's `batch_stats` and
    moves the running stats in place, ``m * momentum + stat * (1 -
    momentum)``; otherwise it normalises by the running stats."""
    if data_format not in ("NC", "NCL", "NCHW", "NCDHW"):
        raise NotImplementedError(
            f"data_format={data_format!r} is not ported: channels first "
            f"only")
    axes = tuple(i for i in range(x.dim()) if i != 1)
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    if training and not use_global_stats:
        mean, var = batch_stats(x, axes)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)
    return _affine(out, weight, bias, shape)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``label (1 - epsilon)`` plus ``epsilon / classes``, or
    ``epsilon prior_dist``."""
    smoothed = label * (1.0 - epsilon)
    if prior_dist is None:
        return smoothed + epsilon / label.shape[-1]
    return smoothed + prior_dist * epsilon


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """Each last-axis vector on the diagonal at `offset` of an [n, n +
    |offset|] matrix (its transpose below the diagonal), as the JAX
    function builds it; `dim1` and `dim2` are unused there too."""
    n = input.shape[-1]
    eye = torch.eye(n, n + abs(offset), dtype=input.dtype,
                    device=input.device).roll(max(offset, 0), dims=1)
    if offset >= 0:
        return torch.einsum("...i,ij->...ij", input, eye)
    return torch.einsum("...i,ij->...ji", input, eye)


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """``[..., maxlen]``: 1 before each length, 0 after; `maxlen` defaults
    to the largest length (a host read)."""
    from ..dtype import convert_dtype

    m = int(maxlen) if maxlen is not None else int(lengths.max())
    mask = torch.arange(m, device=lengths.device) < lengths[..., None]
    return mask.to(convert_dtype(dtype))


def _inplace_alias(fn):
    """``fn`` applied in place: the result written into the input, whose
    autograd history then runs through ``fn`` (a leaf that requires
    grad refuses, as in the JAX package)."""
    def method(x, *args, **kwargs):
        return x.copy_(fn(x.clone(), *args, **kwargs))

    method.__name__ = fn.__name__ + "_"
    return method


relu_ = _inplace_alias(relu)
elu_ = _inplace_alias(elu)
softmax_ = _inplace_alias(softmax)
tanh_ = _inplace_alias(tanh)
