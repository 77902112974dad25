"""The functional namespace (``paddle_tpu/nn/functional.py``): the
activation, softmax and dropout functions of ``ops.nn_ops``, the losses
of ``ops.loss``, ``ops.nn_extra``'s `gather_tree`, `celu` and
`pairwise_distance`, `label_smooth`, `diag_embed`, `sequence_mask` and
the in-place aliases; and the layers' own functions (`linear`,
`layer_norm`, `embedding`, `conv2d`, the pools, `batch_norm`).  Mixed
dtypes promote as JAX promotes them: a bfloat16 operand meeting a
float32 one computes in float32.  Under dygraph AMP (``amp.auto_cast``)
`linear`, `matmul` and `conv2d` first cast their float32 tensors as the
JAX ops ``linear``/``linear_nobias``, ``matmul_v2`` and ``conv2d`` are
cast."""
import torch

from ..amp.auto_cast import amp_enabled, cast_inputs
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
from ..ops.nn_ops import (alpha_dropout, dropout, dropout2d,  # noqa: F401
                          elu, gelu, glu, hardshrink, hardsigmoid,
                          hardswish, hardtanh, leaky_relu, log_sigmoid,
                          log_softmax, maxout, mish, normalize, prelu, relu,
                          relu6, selu, sigmoid, silu, softmax, softplus,
                          softshrink, softsign, swish, tanhshrink,
                          thresholded_relu)


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


def embedding(ids, weight, padding_idx=None):
    """Rows of `weight` [num, dim] at integer `ids`; a lookup of a
    `padding_idx` >= 0 gives zeros, and so no gradient to that row (a
    negative one masks nothing, as in the JAX package: the layer counts
    it from the end first)."""
    out = torch.nn.functional.embedding(ids.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def _pair(v, what):
    if isinstance(v, str):
        raise NotImplementedError(f"a string {what} ({v!r}) is not ported")
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v) * (1 if len(v) == 2 else 2)
    return (int(v),) * 2


def _pads(padding):
    """(top, bottom, left, right) of a paddle 2-D padding: an int, two
    per-axis values or four (top, bottom, left, right); a string
    raises."""
    if isinstance(padding, str):
        raise NotImplementedError(
            f"string padding {padding!r} is not ported")
    if isinstance(padding, int):
        return (padding,) * 4
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        return padding[0], padding[0], padding[1], padding[1]
    if len(padding) == 4:
        return tuple(padding)
    raise ValueError(f"bad padding {padding}")


def _nchw(data_format):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"data_format={data_format!r} is not ported: NCHW only")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution, NCHW input and OIHW weight (``ops/nn_ops.py::
    conv2d``); an asymmetric padding is zero-padded first.  Under AMP x
    and weight are cast (the JAX ``conv2d`` op) and the bias is added
    after, uncast (its ``conv2d_bias`` op): a float32 bias makes the sum
    float32, as in JAX."""
    _nchw(data_format)
    if amp_enabled():
        x, weight = cast_inputs("conv2d", x, weight)
        if bias is not None:
            out = conv2d(x, weight, None, stride, padding, dilation, groups)
            bias, = cast_inputs("conv2d_bias", bias)
            return out + bias.reshape(1, -1, 1, 1)
    t, b, left, r = _pads(padding)
    if t != b or left != r:
        x = torch.nn.functional.pad(x, (left, r, t, b))
        t = left = 0
    return torch.nn.functional.conv2d(
        x, weight, bias, _pair(stride, "stride"), (t, left),
        _pair(dilation, "dilation"), groups)


def _pool_args(kernel_size, stride, padding, ceil_mode, data_format):
    _nchw(data_format)
    if ceil_mode:
        raise NotImplementedError("ceil_mode=True is not ported (the JAX "
                                  "pools ignore it)")
    k = _pair(kernel_size, "kernel_size")
    s = _pair(stride, "stride") if stride is not None else k
    t, b, left, r = _pads(padding)
    if t != b or left != r or 2 * t > k[0] or 2 * left > k[1]:
        raise NotImplementedError(
            f"pool padding {padding} is not ported: symmetric and at most "
            f"half the window only")
    return k, s, (t, left)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max over each window, the padding counting as -inf."""
    if return_mask:
        raise NotImplementedError("return_mask=True is not ported (the JAX "
                                  "pool answers None)")
    k, s, p = _pool_args(kernel_size, stride, padding, ceil_mode,
                         data_format)
    return torch.nn.functional.max_pool2d(x, k, s, p)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Mean over each window; `exclusive` leaves the padding out of the
    count (PyTorch's ``count_include_pad=False``)."""
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not ported (the JAX "
                                  "pool ignores it)")
    k, s, p = _pool_args(kernel_size, stride, padding, ceil_mode,
                         data_format)
    return torch.nn.functional.avg_pool2d(x, k, s, p,
                                          count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Window i of n inputs over o outputs spans ``floor(i n / o)`` to
    ``ceil((i + 1) n / o)``, as ``ops/nn_extra.py::_adaptive_nd``."""
    _nchw(data_format)
    return torch.nn.functional.adaptive_avg_pool2d(
        x, _pair(output_size, "output_size"))


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
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


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
