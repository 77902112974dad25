"""Elementwise, comparison, reduction and linear-algebra ops
(``paddle_tpu/ops/math.py``).

A python scalar meeting a tensor takes the tensor's dtype, a float
scalar making an integer tensor's op float32 (``_coerce``); host data
with no tensor beside it goes to the card (``tensor_like``).  Each op
casts its float32 inputs under dygraph AMP by its JAX op's name
(``amp.auto_cast.cast_inputs``): at O1 only ``matmul_v2`` and ``bmm``
of these are cast, at O2 every op not black-listed.  `topk`, `sort` and
`argsort` order equal values as JAX does, lower index first (stable
sorts; ``torch.topk`` promises no order among equal values on the
card)."""
import numpy as np
import torch

from ..amp.auto_cast import cast_inputs
from ..dtype import convert_dtype
from .creation import tensor_like


def _coerce(x, like, who):
    """`x` as a tensor: a python scalar in `like`'s dtype (a float scalar
    against an integer tensor: float32) on its device; without a tensor
    `like`, on the card (``tensor_like``)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(like, torch.Tensor) and np.isscalar(x):
        dt = like.dtype
        if isinstance(x, (float, np.floating)) and not (
                dt.is_floating_point or dt.is_complex):
            dt = torch.float32
        return torch.tensor(x, dtype=dt, device=like.device)
    return tensor_like(x, like, who)


def _binary(name, fn):
    def op(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = _coerce(x, y, op.op_type)
        if not isinstance(y, torch.Tensor):
            y = _coerce(y, x, op.op_type)
        return fn(*cast_inputs(op.op_type, x, y))

    op.__name__ = op.op_type = name
    return op


add = _binary("elementwise_add", lambda x, y: x + y)
subtract = _binary("elementwise_sub", lambda x, y: x - y)
multiply = _binary("elementwise_mul", lambda x, y: x * y)
divide = _binary("elementwise_div", lambda x, y: torch.true_divide(x, y))
floor_divide = _binary("elementwise_floordiv", torch.floor_divide)
remainder = _binary("elementwise_mod", torch.remainder)
mod = remainder
floor_mod = remainder
pow = _binary("elementwise_pow", torch.pow)
maximum = _binary("elementwise_max", torch.maximum)
minimum = _binary("elementwise_min", torch.minimum)
fmax = _binary("elementwise_fmax", torch.fmax)
fmin = _binary("elementwise_fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)

elementwise_add = add
elementwise_sub = subtract
elementwise_mul = multiply
elementwise_div = divide


def _unary(name, fn):
    def op(x, name=None):
        if not isinstance(x, torch.Tensor):
            x = _coerce(x, None, op.op_type)
        return fn(*cast_inputs(op.op_type, x))

    op.__name__ = op.op_type = name
    return op


abs = _unary("abs", torch.abs)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)     # half to even, as jnp.round
trunc = _unary("trunc", torch.trunc)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", lambda x: 1.0 / x)
neg = _unary("neg", torch.neg)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = scale.item() if isinstance(scale, torch.Tensor) else scale
    x, = cast_inputs("scale", x)
    if bias_after_scale:
        return x * float(s) + float(bias)
    return (x + float(bias)) * float(s)


def clip(x, min=None, max=None, name=None):
    if isinstance(min, torch.Tensor):
        min = min.item()
    if isinstance(max, torch.Tensor):
        max = max.item()
    x, = cast_inputs("clip", x)
    # jnp.clip's order: the lower bound first, then the upper
    if min is not None:
        x = torch.maximum(x, torch.tensor(min, dtype=x.dtype,
                                          device=x.device))
    if max is not None:
        x = torch.minimum(x, torch.tensor(max, dtype=x.dtype,
                                          device=x.device))
    return x


def lerp(x, y, weight):
    x, y, weight = cast_inputs("lerp", x, y, weight)
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    x, = cast_inputs("stanh", x)
    return scale_b * torch.tanh(scale_a * x)


# ---- comparisons and logic: no gradient ----

def _cmp(name, fn):
    def op(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = _coerce(x, y, op.__name__)
        if not isinstance(y, torch.Tensor):
            y = _coerce(y, x, op.__name__)
        return fn(x.detach(), y.detach())

    op.__name__ = name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return torch.logical_not(x)


def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


def equal_all(x, y):
    """A 0-d bool: the same shape and every value equal."""
    same = x.shape == y.shape and bool(torch.equal(x, y))
    return torch.tensor(same, device=x.device)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return torch.tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol, atol, equal_nan)


# ---- reductions ----

def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """`axis` as a tuple of dims (every dim for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _reduce(name, fn):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x, = cast_inputs(op.op_type, x)
        out = fn(x, _dims(x, _axis_arg(axis)), keepdim)
        return out if dtype is None else out.to(convert_dtype(dtype))

    op.__name__ = op.op_type = name
    return op


def _sum_fn(x, dims, keepdim):
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    return torch.sum(x, dim=dims, keepdim=keepdim) if dims else x


def _prod_fn(x, dims, keepdim):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


sum = _reduce("reduce_sum", _sum_fn)
mean = _reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d,
                                                         keepdim=k)
               if d else x)
max = _reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k)
              if d else x)
min = _reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k)
              if d else x)
prod = _reduce("reduce_prod", _prod_fn)
amax = max
amin = min


def all(x, axis=None, keepdim=False, name=None):
    dims = _dims(x, _axis_arg(axis))
    return torch.all(x, dim=dims, keepdim=keepdim) if dims \
        else x.to(torch.bool)


def any(x, axis=None, keepdim=False, name=None):
    dims = _dims(x, _axis_arg(axis))
    return torch.any(x, dim=dims, keepdim=keepdim) if dims \
        else x.to(torch.bool)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x, = cast_inputs("logsumexp_op", x)
    dims = _dims(x, _axis_arg(axis))
    return torch.logsumexp(x, dim=dims, keepdim=keepdim) if dims else x


def _arg(fn, x, axis, keepdim):
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        return out.reshape([1] * x.dim()) if keepdim else out
    return fn(x, dim=axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first index of the largest value (the flattened input's for
    ``axis=None``)."""
    return _arg(torch.argmax, x, axis, keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    x, = cast_inputs("cumsum_op", x)
    out = torch.cumsum(x, dim=int(axis))
    return out if dtype is None else out.to(convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    x, = cast_inputs("cumprod_op", x)
    out = torch.cumprod(x, dim=int(dim))
    return out if dtype is None else out.to(convert_dtype(dtype))


# ---- linear algebra ----

def matmul_promoted(x, y):
    """``x @ y`` in the promoted dtype of x and y, with no AMP cast."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y`` with either operand's last two axes swapped first, in
    their promoted dtype (the JAX ``matmul_v2`` op, cast under AMP)."""
    x, y = cast_inputs("matmul_v2", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return matmul_promoted(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y):
    """Batched ``x @ y`` (the JAX ``bmm`` op, cast under AMP)."""
    return matmul_promoted(*cast_inputs("bmm", x, y))


def dot(x, y, name=None):
    x, y = cast_inputs("dot_op", x, y)
    return torch.sum(x * y, dim=-1)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = cast_inputs("addmm_op", input, x, y)
    return beta * input + alpha * (x @ y)


def t(x):
    """Every axis reversed for 2 or more axes, as numpy's ``.T``."""
    x, = cast_inputs("t_op", x)
    return x.permute(*reversed(range(x.dim()))) if x.dim() >= 2 else x


def outer(x, y):
    x, y = cast_inputs("outer_op", x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def inner(x, y):
    return torch.inner(*cast_inputs("inner_op", x, y))


def kron(x, y):
    return torch.kron(*cast_inputs("kron_op", x, y))


def mv(x, vec):
    x, vec = cast_inputs("mv_op", x, vec)
    return x @ vec


def norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """The p-norm over `axis` (every axis flattened for None; "fro" is
    p 2; inf and -inf the largest and least magnitude)."""
    p = 2.0 if p == "fro" else float(p)
    x, = cast_inputs("p_norm", x)
    axis = _axis_arg(axis)
    if p == float("inf") or p == float("-inf"):
        fn = torch.amax if p > 0 else torch.amin
        dims = _dims(x, axis)
        return fn(x.abs(), dim=dims, keepdim=keepdim) if dims else x.abs()
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sum(x.abs() ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2.0):
    return norm(subtract(x, y), p=p)


# ---- selection, sorting and the rest ----

def where(condition, x=None, y=None, name=None):
    """``x`` where `condition`, else ``y``; with neither, `nonzero`'s
    tuple."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    if not isinstance(x, torch.Tensor):
        # host data beside no other tensor follows the condition's device
        x = _coerce(x, y, "where") if isinstance(y, torch.Tensor) \
            else tensor_like(x, condition, "where")
    if not isinstance(y, torch.Tensor):
        y = _coerce(y, x, "where")
    x, y = cast_inputs("where_op", x, y)
    return torch.where(condition.detach(), x, y)


where_m = where


def nonzero(x, as_tuple=False):
    """The indices of the nonzero entries, [n, ndim] int64, or a tuple of
    n-long index vectors (a host sync: n depends on the data)."""
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def masked_select(x, mask, name=None):
    """The entries of `x` where `mask`, which must broadcast to x's shape,
    flattened in order (a host sync, as in JAX); the gradient scatters
    back into x."""
    mask = mask if isinstance(mask, torch.Tensor) else torch.as_tensor(
        np.asarray(mask, bool), device=x.device)
    try:
        m = torch.broadcast_to(mask.to(torch.bool), x.shape)
    except RuntimeError:
        raise ValueError(f"masked_select: mask shape {tuple(mask.shape)} "
                         f"is not broadcastable to x shape "
                         f"{tuple(x.shape)}") from None
    return x.reshape(-1)[m.reshape(-1)]


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The `k` largest (smallest) values along `axis` (the last for None)
    and their indices, equal values in index order, as ``lax.top_k``."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    axis = -1 if axis is None else axis
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)


def argsort(x, axis=-1, descending=False, name=None):
    """Indices that sort `x` along `axis`, equal values in index order."""
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def sort(x, axis=-1, descending=False, name=None):
    """`x` sorted along `axis`: ascending, then reversed where
    `descending`, as JAX does."""
    s = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(s, [axis]) if descending else s


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """``np.unique`` of `x`, on the host as in JAX; the results go back to
    x's device."""
    res = np.unique(x.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(torch.as_tensor(r, device=x.device) for r in res)
    return torch.as_tensor(res, device=x.device)


def increment(x, value=1.0, name=None):
    """`x` plus `value`, in place; returns x."""
    with torch.no_grad():
        x.add_(value)
    return x


def cross(x, y, axis=9, name=None):
    """The cross product along `axis`; the default 9 means the first axis
    of size 3."""
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    x, y = cast_inputs("cross_op", x, y)
    return torch.linalg.cross(x, y, dim=axis)


def numel_t(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


__all__ = [n for n in dir() if not n.startswith("_") and n not in (
    "np", "torch", "cast_inputs", "convert_dtype", "tensor_like")]
