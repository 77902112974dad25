"""Creation ops (``paddle_tpu/ops/creation.py``) and `to_tensor`.

A function with no tensor argument makes its tensor on `device`, where
None means the card (``device.resolve_device``): without CUDA it raises
instead of making it on the CPU.  One with a tensor argument follows
that tensor's device.  The random ones draw from `generator`, else from
torch's default generator of that device (the JAX package's global key);
their values cannot equal JAX's threefry draws, only their
distribution."""
import numpy as np
import torch

from ..device import resolve_device
from ..dtype import convert_dtype


def _dt(dtype, default="float32"):
    d = convert_dtype(dtype)
    return d if d is not None else convert_dtype(default)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [shape]
    return tuple(int(s) for s in shape)


def tensor_like(value, like, who):
    """`value` as a tensor (float64 data as float32) on the device of
    `like` where that is a tensor, else on the card (`who`, the op, names
    it where ``resolve_device`` raises): host data alone never makes an
    op run on the CPU.  A tensor as it is."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=like.device if isinstance(
        like, torch.Tensor) else resolve_device(None, who))


def to_tensor(data, dtype=None, device=None, stop_gradient=True):
    """`data` (a tensor, an array, a scalar or nested lists) as a tensor on
    `device` (None: the card) in `dtype`; float64 data without a dtype
    becomes float32, as in the JAX package.  ``stop_gradient=False``
    makes it a leaf that requires grad."""
    dev = resolve_device(device, "to_tensor")
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(dev, dt if dt is not None else data.dtype)
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out = torch.as_tensor(arr).to(dev, dt)
    if not stop_gradient:
        out = out.clone().requires_grad_(True)
    return out


def full(shape, fill_value, dtype=None, device=None):
    """A tensor of `shape` filled with `fill_value`; without a dtype, int64
    for an int, bool for a bool, else float32."""
    if dtype is None:
        dtype = ("bool" if isinstance(fill_value, (bool, np.bool_))
                 else "int64" if isinstance(fill_value, (int, np.integer))
                 else "float32")
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device(device, "full"))


fill_constant = full


def zeros(shape, dtype="float32", device=None):
    return full(shape, 0, dtype or "float32", device)


def ones(shape, dtype="float32", device=None):
    return full(shape, 1, dtype or "float32", device)


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))


def empty(shape, dtype="float32", device=None):
    return zeros(shape, dtype, device)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, device=None):
    """``[start, end)`` by `step`; int64 when every bound is an int, else
    float32."""
    if end is None:
        start, end = 0, start
    if any(isinstance(v, torch.Tensor) for v in (start, end, step)):
        raise TypeError("arange bounds must be python scalars")
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) else "float32")
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=resolve_device(device, "arange"))


def linspace(start, stop, num, dtype="float32", device=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=resolve_device(device, "linspace"))


def eye(num_rows, num_columns=None, dtype="float32", device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype),
                     device=resolve_device(device, "eye"))


def diag(x, offset=0, padding_value=0):
    """A vector's diagonal matrix (off the diagonal `padding_value`), or a
    matrix's diagonal, at `offset`."""
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        d = torch.where(mask, d, torch.full_like(d, padding_value))
    return d


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def meshgrid(*args):
    return list(torch.meshgrid(*args, indexing="ij"))


def assign(x, output=None, device=None):
    """A copy of `x` (a tensor, or data made a tensor on `device`) that
    keeps its gradient path; written into `output` where one is given."""
    if not isinstance(x, torch.Tensor):
        x = to_tensor(x, device=device)
    out = x + 0 if x.dtype != torch.bool else x.clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x):
    return assign(x)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, *,
            generator=None, device=None):
    """Uniform in ``[min, max)``; a nonzero `seed` draws from a generator
    of its own seeded with it."""
    dev = resolve_device(device, "uniform")
    if seed:
        generator = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(_shape(shape), generator=generator, device=dev,
                   dtype=_dt(dtype))
    return u * (max - min) + min


uniform_random = uniform


def rand(shape, dtype="float32", *, generator=None, device=None):
    return uniform(shape, dtype, min=0.0, max=1.0, generator=generator,
                   device=device)


def randn(shape, dtype="float32", *, generator=None, device=None):
    return torch.randn(_shape(shape), generator=generator,
                       device=resolve_device(device, "randn"),
                       dtype=_dt(dtype))


def normal(mean=0.0, std=1.0, shape=None, *, generator=None, device=None):
    out = torch.randn(_shape(shape or []), generator=generator,
                      device=resolve_device(device, "normal"))
    return out * std + mean


gaussian = normal


def randint(low=0, high=None, shape=(1,), dtype="int64", *, generator=None,
            device=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, _shape(shape), generator=generator,
                         device=resolve_device(device, "randint"),
                         dtype=_dt(dtype, "int64"))


def randperm(n, dtype="int64", *, generator=None, device=None):
    return torch.randperm(n, generator=generator,
                          device=resolve_device(device, "randperm"),
                          dtype=_dt(dtype, "int64"))


def bernoulli(x, *, generator=None):
    """1 with probability `x`, else 0, in x's dtype."""
    return torch.bernoulli(x, generator=generator)


def multinomial(x, num_samples=1, replacement=False, *, generator=None):
    """`num_samples` class indices per row of the probabilities `x`."""
    return torch.multinomial(x, num_samples, replacement,
                             generator=generator)


__all__ = ["arange", "assign", "bernoulli", "clone", "diag", "empty",
           "empty_like", "eye", "fill_constant", "full", "full_like",
           "gaussian", "linspace", "meshgrid", "multinomial", "normal",
           "ones", "ones_like", "rand", "randint", "randn", "randperm",
           "to_tensor", "tril", "triu", "uniform", "uniform_random",
           "zeros", "zeros_like"]
