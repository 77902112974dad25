"""The functional ops GPT, BERT and ERNIE need, with the JAX package's
semantics (``paddle_tpu/ops/nn_ops.py``, ``ops/loss.py``).  Mixed dtypes
promote as JAX promotes them: a bfloat16 operand meeting a float32 one
computes in float32.  Under dygraph AMP (``amp.auto_cast``) `linear`,
`matmul` and `conv2d` first cast their float32 tensors as the JAX ops
``linear``/``linear_nobias``, ``matmul_v2`` and ``conv2d`` are cast."""
import torch

from ..amp.auto_cast import amp_enabled, cast_inputs


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


def matmul_promoted(x, y):
    """``x @ y`` in the promoted dtype of x and y, with no AMP cast."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y`` with either operand's last two axes swapped first, in
    their promoted dtype (the JAX ``matmul_v2`` op, cast under AMP)."""
    x, y = cast_inputs("matmul_v2", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return matmul_promoted(x, y)


def layer_norm(x, weight, bias, epsilon=1e-5):
    """Normalise over the last axis: mean, centred variance,
    ``(x - mean) * rsqrt(var + epsilon)``, then weight and bias (which
    promote a bfloat16 x to their float32)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + epsilon) * weight + bias


def gelu(x):
    """Exact GELU, ``0.5 x (1 + erf(x / sqrt 2))`` (approximate=False)."""
    return torch.nn.functional.gelu(x)


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def dropout(x, p, training=True, generator=None):
    """``upscale_in_train`` dropout: keep with probability 1 - p and
    divide by it; identity when not training or p == 0.  The keep mask
    draws from `generator`, which it then requires."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout draws from an explicit torch.Generator: "
                         "pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def embedding(ids, weight):
    """Rows of `weight` [num, dim] at integer `ids`."""
    return torch.nn.functional.embedding(ids.long(), weight)


IGNORE_INDEX = -100


def softmax_with_cross_entropy(logits, label):
    """Per-position ``-log_softmax(logits)[label]`` with a trailing 1
    ([..., 1]); a label [..., 1] is squeezed first; IGNORE_INDEX
    positions give 0 (their label is clamped before the gather)."""
    logp = torch.log_softmax(logits, dim=-1)
    li = label
    if li.dim() == logits.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    li = li.long()
    safe = li.clamp(0, logits.shape[-1] - 1)
    picked = logp.gather(-1, safe.unsqueeze(-1))
    return torch.where((li == IGNORE_INDEX).unsqueeze(-1),
                       torch.zeros_like(picked), -picked)


def _reduce_loss(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=IGNORE_INDEX,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    """``ops/loss.py::cross_entropy``: ``-log_softmax(input)`` at the
    label along `axis` (``log(max(input, 1e-30))`` without
    `use_softmax`), times the label's class `weight`, 0 at
    `ignore_index`; a `soft_label` is a distribution, ``-sum(label *
    logp)``.  The hard-label mean divides the sum by the summed weights
    of the labels not ignored (their count without `weight`), at least
    1e-12; otherwise `reduction` is "mean", "sum" or "none"."""
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(torch.clamp(input, min=1e-30)))
    if soft_label:
        return _reduce_loss(-(label * logp).sum(dim=axis), reduction)
    li = label
    if li.dim() == input.dim() and li.shape[axis] == 1:
        li = li.squeeze(axis)
    safe = li.long().clamp(0, input.shape[axis] - 1)
    loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(li == ignore_index, torch.zeros_like(loss), loss)
    if reduction != "mean":
        return _reduce_loss(loss, reduction)
    if weight is not None:
        w_safe = label.long().clamp(0, weight.shape[0] - 1)
        denom = torch.where(label == ignore_index,
                            torch.zeros((), dtype=weight.dtype,
                                        device=weight.device),
                            weight[w_safe]).sum()
    else:
        denom = (label != ignore_index).sum().to(loss.dtype)
    return loss.sum() / torch.clamp(denom, min=1e-12)


def mse_loss(input, label, reduction="mean"):
    """``(input - label)²``, reduced by `reduction`."""
    return _reduce_loss((input - label).square(), reduction)


def relu6(x):
    """``clip(x, 0, 6)``."""
    return torch.clamp(x, 0.0, 6.0)


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


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
