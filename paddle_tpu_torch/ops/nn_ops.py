"""Activation, softmax, normalize and dropout functions
(``paddle_tpu/ops/nn_ops.py``: ``_act`` and its table, `softplus`
through `maxout`, `normalize`, `dropout`, `dropout2d`,
`alpha_dropout`), with the JAX package's arithmetic.  Each casts its
float32 input under dygraph AMP by its JAX op's name (none of these is
on the O1 white list).  Dropout masks draw from an explicit
``torch.Generator`` on the input's device."""
import torch

from ..amp.auto_cast import cast_inputs
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


__all__ = ["alpha_dropout", "dropout", "dropout2d", "elu", "gelu", "glu",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "leaky_relu", "log_sigmoid", "log_softmax", "maxout", "mish",
           "normalize", "prelu", "relu", "relu6", "selu", "sigmoid", "silu",
           "softmax", "softplus", "softshrink", "softsign", "swish",
           "tanhshrink", "thresholded_relu"]
