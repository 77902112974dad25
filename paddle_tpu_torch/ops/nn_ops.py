"""Activation, softmax, normalize and dropout functions, convolutions,
pools, instance, group and local response norms, and resampling
(``paddle_tpu/ops/nn_ops.py``: ``_act`` and its table, `softplus`
through `maxout`, `normalize`, `dropout`, `dropout2d`,
`alpha_dropout`, `conv1d`, `conv2d`, `conv2d_transpose`, the 1-D and
2-D pools, `instance_norm`, `group_norm`, `local_response_norm`,
`interpolate`, `pixel_shuffle`, `unfold`), with the JAX package's
arithmetic.  Each casts its float32 inputs under dygraph AMP by its JAX
op's name (the convolutions are on the O1 white list; a bias is added
after the cast convolution, by its own op, as in JAX).  Dropout masks
draw from an explicit ``torch.Generator`` on the input's device."""
import math

import torch
import torch.nn.functional as tF

from ..amp.auto_cast import amp_enabled, cast_inputs
from .manipulation import cast, split


def _act(name, fn):
    def op(x, name=None):
        return fn(*cast_inputs(op.op_type, x))

    op.__name__ = op.op_type = name
    return op


def _softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


relu = _act("relu", torch.relu)
relu6 = _act("relu6", lambda x: _clip(x, 0.0, 6.0))
sigmoid = _act("sigmoid", torch.sigmoid)
log_sigmoid = _act("logsigmoid", lambda x: -_softplus(-x))
silu = _act("silu", lambda x: x * torch.sigmoid(x))
swish = silu
mish = _act("mish", lambda x: x * torch.tanh(_softplus(x)))
softplus_raw = _act("softplus", _softplus)
softsign = _act("softsign", lambda x: x / (torch.abs(x) + 1))
tanhshrink = _act("tanh_shrink", lambda x: x - torch.tanh(x))
hardsigmoid = _act("hard_sigmoid",
                   lambda x: _clip(x / 6.0 + 0.5, 0.0, 1.0))
hardswish = _act("hard_swish", lambda x: x * _clip(x + 3, 0.0, 6.0) / 6)
hardtanh = _act("hard_tanh", lambda x: _clip(x, -1.0, 1.0))
selu_raw = _act("selu", torch.selu)


def softplus(x, beta=1, threshold=20, name=None):
    """``softplus(x)`` at beta 1 (the threshold unused, as in JAX), else
    x where ``x beta > threshold`` and ``softplus(x beta) / beta``."""
    if beta == 1:
        return softplus_raw(x)
    x, = cast_inputs("softplus_beta", x)
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """``jax.nn.selu``: its own constants, whatever `scale` and `alpha`
    say, as in the JAX package."""
    return selu_raw(x)


def gelu(x, approximate=False, name=None):
    """GELU, exact ``0.5 x (1 + erf(x / sqrt 2))`` or, with `approximate`,
    the tanh form."""
    x, = cast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    x, = cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    x, = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where ``x >= 0``, else ``weight x``: one weight, or one per
    channel (axis 1 for NCHW, the last axis otherwise)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def hardshrink(x, threshold=0.5, name=None):
    x, = cast_inputs("hardshrink", x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x, = cast_inputs("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def thresholded_relu(x, threshold=1.0, name=None):
    x, = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    x, = cast_inputs("softmax", x)
    return torch.softmax(x, dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    """`dtype` is accepted and unused, as in the JAX package."""
    x, = cast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=int(axis))


def glu(x, axis=-1, name=None):
    a, b = split(x, 2, axis=axis)
    return a * sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    """The largest of each `groups` consecutive channels along `axis`."""
    x, = cast_inputs("maxout", x)
    shape = list(x.shape)
    shape[axis: axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along `axis`."""
    x, = cast_inputs("normalize", x)
    n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def _keep_mask(x, q, shape, generator):
    if generator is None:
        raise ValueError("dropout draws from an explicit torch.Generator: "
                         "pass generator=")
    return torch.rand(shape, generator=generator, device=x.device) < q


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Keep each value (each slice along `axis`, where given) with
    probability 1 - p: ``upscale_in_train`` divides the kept by it in
    training and is the identity otherwise; ``downscale_in_infer``
    keeps them as they are in training and scales by 1 - p otherwise.
    The mask draws from `generator`, which training with 0 < p < 1
    requires."""
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1 - p)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _keep_mask(x, 1.0 - p, shape, generator)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x)).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """`dropout` of whole channels."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU-preserving dropout: a dropped value becomes alpha', then
    ``a x + b`` keeps the mean and variance."""
    if not training or p == 0:
        return x
    alpha_p = -1.7580993408473766
    q = 1 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    keep = _keep_mask(x, q, tuple(x.shape), generator)
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


# ------------------------------ convolutions ------------------------------

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}
_MAX_POOL = {2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG_POOL = {2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _ntuple(v, n):
    """JAX's ``_pair(v, n)``: an int repeated `n` times; a list of `n`
    as it is, a list of another length repeated `n` times."""
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v) * (1 if len(v) == n else n)
    return (int(v),) * n


def _conv_padding(padding, nd):
    """``ops/nn_ops.py::_conv_padding``: "SAME" or "VALID" for a string,
    else one (lo, hi) per spatial axis from an int, `nd` values or `2 nd`
    values (lo, hi of each axis in turn)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(sizes, window, stride):
    """XLA's SAME padding of each axis: ceil(n / stride) outputs, the
    total pad split with its smaller half first."""
    pads = []
    for n, w, s in zip(sizes, window, stride):
        total = max((-(-n // s) - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _explicit_pads(padding, sizes, kernel, stride, dilation):
    """(lo, hi) per spatial axis of a forward convolution's `padding`."""
    pads = _conv_padding(padding, len(sizes))
    if pads == "VALID":
        return [(0, 0)] * len(sizes)
    if pads == "SAME":
        return _same_pads(sizes, [d * (k - 1) + 1 for k, d in
                                  zip(kernel, dilation)], stride)
    if isinstance(pads, str):
        raise ValueError(f"unknown padding {padding!r}")
    return pads


def _flat(pads):
    """`pads` [(lo, hi), ...] of the spatial axes as ``F.pad`` reads
    them, the last axis first."""
    return [p for pair in reversed(pads) for p in pair]


def _conv(x, weight, bias, stride, pads, dilation, groups, nd):
    """A channels-first `nd`-D convolution with (lo, hi) `pads`: an
    uneven pair zero-pads the input first."""
    if any(lo != hi or lo < 0 for lo, hi in pads):
        x = tF.pad(x, _flat(pads))
        pads = [(0, 0)] * nd
    return _CONV[nd](x, weight, bias, stride, [lo for lo, _ in pads],
                     dilation, groups)


def _biased(out, bias, op, shape):
    """`out` plus `bias` reshaped to `shape`, the bias cast under AMP as
    the JAX op `op` casts it."""
    if bias is None:
        return out
    bias, = cast_inputs(op, bias)
    return out + bias.reshape(shape)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution with an OIHW weight, NCHW or (`data_format`
    "NHWC") channels-last input; `padding` an int, two per-axis values,
    four (top, bottom, left, right) or "SAME"/"VALID".  Under AMP x and
    weight are cast (the JAX ``conv2d`` op) and the bias is added after,
    uncast (its ``conv2d_bias`` op): a float32 bias makes the sum
    float32, as in JAX."""
    stride, dilation = _ntuple(stride, 2), _ntuple(dilation, 2)
    nhwc = data_format != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    pads = _explicit_pads(padding, x.shape[2:], weight.shape[2:], stride,
                          dilation)
    split_bias = amp_enabled() and bias is not None
    x, weight = cast_inputs("conv2d", x, weight)
    out = _conv(x, weight, None if split_bias else bias, stride, pads,
                dilation, groups, 2)
    if split_bias:
        out = _biased(out, bias, "conv2d_bias", (1, -1, 1, 1))
    return out.permute(0, 2, 3, 1) if nhwc else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution of NCL input, weight [out, in / groups, k];
    `padding` an int, "SAME"/"VALID", or a list whose first and last
    entries are (lo, hi).  NLC raises: the JAX function feeds an NLC
    input to its NCL convolution as it is."""
    if data_format != "NCL":
        raise NotImplementedError(
            f"conv1d data_format={data_format!r} is not ported: the JAX "
            f"function convolves any input as NCL")
    s, d = _ntuple(stride, 1), _ntuple(dilation, 1)
    if isinstance(padding, int):
        pads = [(padding, padding)]
    elif isinstance(padding, str):
        pads = _explicit_pads(padding, x.shape[2:], weight.shape[2:], s, d)
    else:
        pads = [(int(padding[0]), int(padding[-1]))]
    x, weight = cast_inputs("conv1d", x, weight)
    return _biased(_conv(x, weight, None, s, pads, d, groups, 1), bias,
                   "conv1d_bias", (1, -1, 1))


def _conv_transpose(x, weight, stride, pads, dilation, groups, opad, nd):
    """``ops/nn_ops.py::_conv_transpose_nd``: the transposed convolution
    of weight [in, out / groups, *k] with forward pads (lo, hi) per axis,
    `opad` extending the hi side.  PyTorch's own takes even pads and an
    output padding under the stride (or dilation); any other is cut from
    the full transposed output, or zero-filled past its end."""
    if all(lo == hi and lo >= 0 for lo, hi in pads) and all(
            0 <= o < max(s, d) for o, s, d in zip(opad, stride, dilation)):
        return _CONV_T[nd](x, weight, None, stride, [lo for lo, _ in pads],
                           list(opad), groups, dilation)
    full = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    return tF.pad(full, _flat([(-lo, o - hi)
                               for (lo, hi), o in zip(pads, opad)]))


def _transpose_same(kernel, stride, dilation, opad):
    """A SAME transposed convolution's forward pads (out = in * stride):
    total ``dilation (k - 1) + 1 - stride``, a negative total becoming
    extra output padding."""
    pads, opad = [], list(opad)
    for i, (k, s, d) in enumerate(zip(kernel, stride, dilation)):
        total = d * (k - 1) + 1 - s
        if total < 0:
            opad[i] -= total
            total = 0
        pads.append((total // 2, total - total // 2))
    return pads, tuple(opad)


def _transpose_string(padding, kernel, stride, dilation, opad, what):
    p = padding.upper()
    if p == "VALID":
        return [(0, 0)] * len(kernel), opad
    if p == "SAME":
        return _transpose_same(kernel, stride, dilation, opad)
    raise ValueError(f"{what} padding string must be 'SAME' or 'VALID'")


def _output_size_padding(x, kernel, stride, pads, dilation, output_size):
    """The output padding that makes the result `output_size`."""
    return tuple(
        int(output_size[i])
        - ((x.shape[2 + i] - 1) * stride[i] - pads[i][0] - pads[i][1]
           + dilation[i] * (kernel[i] - 1) + 1)
        for i in range(len(kernel)))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    """2-D transposed convolution of NCHW input, weight [in, out /
    groups, kh, kw]: `padding` as `conv2d`'s or "SAME" (out = in x
    stride) / "VALID"; `output_padding` extends the bottom and right
    edges; `output_size` sets the output padding that reaches it.
    `data_format` is unused: the JAX function reads NCHW whatever it
    says."""
    stride, dilation = _ntuple(stride, 2), _ntuple(dilation, 2)
    opad = _ntuple(output_padding, 2)
    k = tuple(weight.shape[2:4])
    if isinstance(padding, str):
        pads, opad = _transpose_string(padding, k, stride, dilation, opad,
                                       "conv2d_transpose")
    else:
        pads = _conv_padding(padding, 2)
    if output_size is not None:
        opad = _output_size_padding(x, k, stride, pads, dilation,
                                    output_size)
    x, weight = cast_inputs("conv2d_transpose", x, weight)
    out = _conv_transpose(x, weight, stride, pads, dilation, groups, opad, 2)
    return _biased(out, bias, "conv2d_transpose_bias", (1, -1, 1, 1))


# --------------------------------- pools ----------------------------------

def _window_pool(x, kind, k, s, pads, exclusive):
    """Max or mean over each `k` window at stride `s` of a channels-first
    `x` padded by (lo, hi) `pads`: the padding counts as -inf for the max;
    a mean divides by the window's size, or (`exclusive`) by its count of
    values that are not padding.  PyTorch's pools take even pads of at
    most half the window; any other pads explicitly."""
    nd = len(k)
    even = all(lo == hi and 0 <= 2 * lo <= w for (lo, hi), w in zip(pads, k))
    if kind == "max":
        if even:
            return _MAX_POOL[nd](x, k, s, [lo for lo, _ in pads])
        return _MAX_POOL[nd](tF.pad(x, _flat(pads), value=-math.inf), k, s)
    if even:
        return _AVG_POOL[nd](x, k, s, [lo for lo, _ in pads],
                             count_include_pad=not exclusive)
    xp = tF.pad(x, _flat(pads))
    if not exclusive:
        return _AVG_POOL[nd](xp, k, s)
    ones = tF.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                             device=x.device), _flat(pads))
    return (_AVG_POOL[nd](xp, k, s, divisor_override=1)
            / _AVG_POOL[nd](ones, k, s, divisor_override=1))


def _pool2d(x, kind, kernel_size, stride, padding, data_format,
            exclusive=True):
    """``ops/nn_ops.py::_pool`` (not adaptive): NCHW or NHWC, `padding`
    as `conv2d`'s.  A mean over an explicit nonzero padding divides by
    each window's count of values when `exclusive`; under "SAME" it
    divides by the window's size, padding included, as in JAX."""
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride, 2) if stride is not None else k
    nhwc = data_format != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    pads = _conv_padding(padding, 2)
    if pads == "VALID":
        pads, exclusive = [(0, 0)] * 2, False
    elif pads == "SAME":
        pads, exclusive = _same_pads(x.shape[2:], k, s), False
    elif isinstance(pads, str):
        raise ValueError(f"unknown padding {padding!r}")
    elif all(p == (0, 0) for p in pads):
        exclusive = False
    x, = cast_inputs("pool2d_" + kind, x)
    out = _window_pool(x, kind, k, s, pads, exclusive)
    return out.permute(0, 2, 3, 1) if nhwc else out


def _refuse_ceil(ceil_mode):
    if ceil_mode:
        raise NotImplementedError("ceil_mode=True is not ported (the JAX "
                                  "1-D and 2-D pools ignore it)")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max over each window, the padding counting as -inf.  `ceil_mode`
    and `return_mask` raise (the JAX pool ignores the one and answers
    None for the other)."""
    if return_mask:
        raise NotImplementedError("return_mask=True is not ported (the JAX "
                                  "pool answers None)")
    _refuse_ceil(ceil_mode)
    return _pool2d(x, "max", kernel_size, stride, padding, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over each window; `exclusive` leaves an explicit padding out
    of the count.  `ceil_mode` and `divisor_override` raise (the JAX pool
    ignores them)."""
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not ported (the JAX "
                                  "pool ignores it)")
    _refuse_ceil(ceil_mode)
    return _pool2d(x, "avg", kernel_size, stride, padding, data_format,
                   exclusive)


def _adaptive(x, kind, output_size, nd):
    """Window i of n inputs over o outputs spans ``floor(i n / o)`` to
    ``ceil((i + 1) n / o)`` (``ops/nn_extra.py::_adaptive_nd``, and
    PyTorch's adaptive pools alike); a mean divides by its count."""
    out = _ntuple(output_size, nd)
    if kind == "max":
        x, = cast_inputs("adaptive_pool_max", x)
        return getattr(tF, f"adaptive_max_pool{nd}d")(x, out)
    x, = cast_inputs("adaptive_pool_avg", x)
    return getattr(tF, f"adaptive_avg_pool{nd}d")(x, out)


def _refuse_mask(return_mask):
    if return_mask:
        raise NotImplementedError("return_mask=True is not ported (the JAX "
                                  "adaptive pools answer None)")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    nhwc = data_format != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    out = _adaptive(x, "avg", output_size, 2)
    return out.permute(0, 2, 3, 1) if nhwc else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _refuse_mask(return_mask)
    return _adaptive(x, "max", output_size, 2)


def _pool1d(x, kind, kernel_size, stride, padding, ceil_mode):
    """A 1-D pool as the JAX package means it: the 2-D pool of [N, C, L,
    1] with a window of (k, 1); `padding` a string, an int or one or two
    (lo, hi) values pads L only.  (The JAX function hands its own
    (lo, hi) pairs to a parser that reads ints, so only a string padding
    runs there; ROADMAP's known differences.)"""
    _refuse_ceil(ceil_mode)
    ks = _ntuple(kernel_size, 1) + (1,)
    st = (_ntuple(stride, 1) + (1,)) if stride is not None else ks
    if not isinstance(padding, str):
        lo, hi = _ntuple(padding, 1) * 2 if isinstance(padding, int) or \
            len(padding) == 1 else _ntuple(padding, 2)
        padding = [lo, hi, 0, 0]
    return _pool2d(x.unsqueeze(3), kind, ks, st, padding,
                   "NCHW").squeeze(3)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               name=None):
    return _pool1d(x, "max", kernel_size, stride, padding, ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               name=None):
    """Mean over each window, a padding left out of the count (the JAX
    function takes no `exclusive`)."""
    return _pool1d(x, "avg", kernel_size, stride, padding, ceil_mode)


# ------------------------------ normalization -----------------------------

def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, weight=None, bias=None, epsilon=1e-5, name=None):
    """Each sample's channel normalised over its spatial axes by its mean
    and biased variance, then the per-channel weight and bias."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    return _affine(out, weight, bias, [1, x.shape[1]] + [1] * (x.dim() - 2))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Each sample's `num_groups` groups of consecutive channels
    normalised over the group's channels and spatial axes, then the
    per-channel weight and bias.  `data_format` is unused: the JAX
    function reads channels first whatever it says."""
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias, [1, c] + [1] * (x.dim() - 2))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, name=None):
    """``x / (k + alpha * s) ** beta``, s the sum of squares over `size`
    neighbouring channels (``size // 2`` before, the rest after)."""
    x, = cast_inputs("lrn", x)
    half = size // 2
    sqp = tF.pad(x.square(), [0, 0] * (x.dim() - 2) + [half, size - 1 - half])
    acc = 0
    for i in range(size):
        acc = acc + sqp[:, i:i + x.shape[1]]
    return x / torch.pow(k + alpha * acc, beta)


# ------------------------------- resampling -------------------------------

def _src(n_in, n_out, align_corners, device):
    """float32 source coordinates of `n_out` outputs over `n_in` inputs
    (``interpolate``'s ``_src``): with `align_corners` the ends meet
    (index 0 when n_out is 1), else half-pixel centres."""
    k = torch.arange(n_out, dtype=torch.float32, device=device)
    if align_corners:
        return k * ((n_in - 1.0) / (n_out - 1.0) if n_out > 1 else 0.0)
    return (k + 0.5) * (n_in / n_out) - 0.5


def _nearest_index(n_in, n_out, align_corners, device):
    if align_corners:
        i = torch.floor(_src(n_in, n_out, True, device) + 0.5)
    else:
        k = torch.arange(n_out, dtype=torch.float32, device=device)
        i = torch.floor(k * (n_in / n_out))
    return torch.clamp(i.long(), 0, n_in - 1)


def _cubic_axis(u, n_in, n_out, axis, align_corners):
    """Cubic convolution along `axis` with A = -0.75 and the taps
    clamped to the border."""
    s = _src(n_in, n_out, align_corners, u.device)
    x1 = torch.floor(s)
    t = s - x1
    a = -0.75
    d0, d1, d2, d3 = 1.0 + t, t, 1.0 - t, 2.0 - t
    ws = [a * d0 ** 3 - 5 * a * d0 ** 2 + 8 * a * d0 - 4 * a,
          (a + 2) * d1 ** 3 - (a + 3) * d1 ** 2 + 1,
          (a + 2) * d2 ** 3 - (a + 3) * d2 ** 2 + 1,
          a * d3 ** 3 - 5 * a * d3 ** 2 + 8 * a * d3 - 4 * a]
    shape = [1] * u.dim()
    shape[axis] = n_out
    acc = 0.0
    for off, w in zip((-1, 0, 1, 2), ws):
        ii = torch.clamp(x1.long() + off, 0, n_in - 1)
        acc = acc + torch.index_select(u, axis, ii) * w.reshape(shape)
    return acc


def _linear_weights(n_in, n_out, device):
    """``jax.image.resize``'s [n_in, n_out] triangle-kernel weights
    (``scale_and_translate``, antialiased): the kernel widens by the
    downsampling factor, each output's weights sum to 1, and an output
    centred outside the input gets none."""
    scale = n_out / n_in
    inv = 1.0 / scale
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    grid = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample[None, :] - grid[:, None]) / max(inv, 1.0)
    w = torch.clamp(1 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(
        torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW", name=None):
    """Resize the two spatial axes of NCHW or NHWC `x` to `size`, or to
    ``int(n * scale_factor)``, as the JAX function does: "nearest"
    takes ``floor(k in / out)`` (rounding on the align-corners grid);
    "bicubic" is cubic convolution with A = -0.75, taps clamped;
    "bilinear" with `align_corners` blends the four neighbours on that
    grid, and without it is ``jax.image.resize``'s linear resize, which
    antialiases when it shrinks an axis."""
    nhwc = data_format != "NCHW"
    h, w = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = (scale_factor, scale_factor)
        size = (int(h * scale_factor[0]), int(w * scale_factor[1]))
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    oh, ow = (int(s) for s in size)
    if mode not in ("nearest", "bilinear", "bicubic"):
        raise ValueError(f"interpolate mode {mode!r}: the JAX function "
                         f"takes nearest, bilinear and bicubic")
    op = {"nearest": "interpolate_nearest", "bicubic": "interpolate_bicubic",
          "bilinear": "interpolate_ac" if align_corners
          else "interpolate"}[mode]
    x, = cast_inputs(op, x)
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    dev = x.device
    if mode == "nearest":
        out = x[:, :, _nearest_index(h, oh, align_corners, dev)][
            :, :, :, _nearest_index(w, ow, align_corners, dev)]
    elif mode == "bicubic":
        out = _cubic_axis(x.float(), h, oh, 2, align_corners)
        out = _cubic_axis(out, w, ow, 3, align_corners).to(x.dtype)
    elif align_corners:
        ys, xs = _src(h, oh, True, dev), _src(w, ow, True, dev)
        y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
        y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1,
                                                             max=w - 1)
        wy = (ys - y0)[None, None, :, None]
        wx = (xs - x0)[None, None, None, :]

        def g(yi, xi):
            return x[:, :, yi][:, :, :, xi]

        out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
               + g(y1, x0) * wy * (1 - wx)
               + g(y1, x1) * wy * wx).to(x.dtype)
    else:
        out = x
        if oh != h:
            out = torch.einsum("nchw,ho->ncow", out, _linear_weights(
                h, oh, dev).to(out.dtype))
        if ow != w:
            out = torch.einsum("nchw,wo->ncho", out, _linear_weights(
                w, ow, dev).to(out.dtype))
    return out.permute(0, 2, 3, 1) if nhwc else out


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """[N, C r², H, W] to [N, C, H r, W r].  `data_format` is unused: the
    JAX function reads NCHW whatever it says."""
    r = upscale_factor
    x, = cast_inputs("pixel_shuffle", x)
    n, c, h, w = x.shape
    v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return v.reshape(n, c // (r * r), h * r, w * r)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of NCHW `x`: [N, C kh kw, L], each column one window
    (channels outer, then the window's rows and columns); `paddings` as
    `conv2d`'s padding."""
    k, s, d = (_ntuple(kernel_sizes, 2), _ntuple(strides, 2),
               _ntuple(dilations, 2))
    x, = cast_inputs("unfold", x)
    pads = _explicit_pads(paddings, x.shape[2:], k, s, d)
    return tF.unfold(tF.pad(x, _flat(pads)), k, dilation=d, stride=s)


__all__ = ["adaptive_avg_pool2d", "adaptive_max_pool2d", "alpha_dropout",
           "avg_pool1d", "avg_pool2d", "conv1d", "conv2d",
           "conv2d_transpose", "dropout", "dropout2d", "elu", "gelu", "glu",
           "group_norm", "hardshrink", "hardsigmoid", "hardswish",
           "hardtanh", "instance_norm", "interpolate", "leaky_relu",
           "local_response_norm", "log_sigmoid", "log_softmax",
           "max_pool1d", "max_pool2d", "maxout", "mish", "normalize",
           "pixel_shuffle", "prelu", "relu", "relu6", "selu", "sigmoid",
           "silu", "softmax", "softplus", "softshrink", "softsign", "swish",
           "tanhshrink", "thresholded_relu", "unfold", "upsample"]
