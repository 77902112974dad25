"""The functional ops GPT, BERT and ERNIE need, with the JAX package's
semantics (``paddle_tpu/ops/nn_ops.py``, ``ops/loss.py``).  Mixed dtypes
promote as JAX promotes them: a bfloat16 operand meeting a float32 one
computes in float32."""
import torch


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with weight [in, out], in the promoted dtype
    of x and weight (float32 x and bfloat16 weight: float32)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    return out if bias is None else out + bias


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
    conv2d``); an asymmetric padding is zero-padded first."""
    _nchw(data_format)
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
