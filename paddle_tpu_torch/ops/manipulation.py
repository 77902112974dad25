"""Shape, indexing and joining ops (``paddle_tpu/ops/manipulation.py``)
with paddle's axis and shape conventions: `reshape`'s 0 copies the
input's size at that position, `squeeze` takes a list of axes and skips
those not of size 1, `slice` takes axes, starts and ends, `scatter`
overwrites or sums, `pad` lists its pairs last spatial axis first.
Index arguments may be tensors, arrays or lists; they go to the input's
device.  `concat`, `stack` and `one_hot` given host data alone make it
on the card (``tensor_like``)."""
import builtins

import numpy as np
import torch

from ..dtype import convert_dtype
from .creation import tensor_like

_pyslice = builtins.slice


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in v]


def _index(index, like):
    """`index` as an int64 tensor on `like`'s device."""
    if isinstance(index, torch.Tensor):
        return index.to(like.device, torch.int64)
    return torch.as_tensor(np.asarray(index), dtype=torch.int64,
                           device=like.device)


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def reshape(x, shape, name=None):
    shape = _ints(shape)
    return torch.reshape(x, [x.shape[i] if s == 0 else s
                             for i, s in enumerate(shape)])


def transpose(x, perm, name=None):
    return x.permute(*[int(p) for p in perm])


def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(a for a in _ints(axis) if x.shape[a] == 1)
    if not axes:
        return x.clone()
    return torch.squeeze(x, axes)


def unsqueeze(x, axis, name=None):
    axes = _ints(axis)
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def concat(x, axis=0, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    like = next((t for t in x if isinstance(t, torch.Tensor)), None)
    return torch.cat([tensor_like(t, like, "concat") for t in x],
                     dim=axis)


def stack(x, axis=0, name=None):
    like = next((t for t in x if isinstance(t, torch.Tensor)), None)
    return torch.stack([tensor_like(t, like, "stack") for t in x],
                       dim=axis)


def split(x, num_or_sections, axis=0, name=None):
    """Equal parts (the size must divide) or the given sizes, one of them
    -1 for the rest."""
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    axis = int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(f"split: axis {axis} size {dim} is not "
                             f"divisible by {num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = _ints(num_or_sections)
        if any(s < 0 for s in sizes):
            rest = dim - builtins.sum(s for s in sizes if s >= 0)
            sizes = [rest if s < 0 else s for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0):
    return list(torch.unbind(x, dim=axis))


def unstack(x, axis=0, num=None):
    return unbind(x, axis=axis)


def slice(x, axes, starts, ends):
    """``x[starts:ends]`` along each of `axes`, python's clamping."""
    idx = [_pyslice(None)] * x.dim()
    for ax, st, en in zip(axes, _ints(starts), _ints(ends)):
        idx[ax] = _pyslice(st, en)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """`slice` with a step per axis; a negative step walks backwards."""
    for ax, st, en, sd in zip(axes, _ints(starts), _ints(ends),
                              _ints(strides)):
        keep = np.arange(x.shape[ax])[_pyslice(st, en, sd)].copy()
        x = x.index_select(ax, torch.as_tensor(keep, device=x.device))
    return x


def getitem(x, idx):
    return x[idx]


def tile(x, repeat_times, name=None):
    return torch.tile(x, tuple(_ints(repeat_times)))


def expand(x, shape, name=None):
    """`x` broadcast to `shape`; -1 (or None) keeps the input's size."""
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    target = [s if s is None else int(s.item()) if isinstance(
        s, torch.Tensor) else int(s) for s in shape]
    xshape = (1,) * (len(target) - x.dim()) + tuple(x.shape)
    target = [xs if t in (-1, None) else t for t, xs in zip(target, xshape)]
    return x.reshape(xshape).expand(target)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [expand(t, list(shape)) for t in inputs]


def flip(x, axis, name=None):
    return torch.flip(x, _ints(axis))


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.tolist()
    shifts = tuple(shifts) if isinstance(shifts, (list, tuple)) \
        else int(shifts)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, tuple(axis) if isinstance(
        axis, (list, tuple)) else axis)


def gather(x, index, axis=0, name=None):
    """Rows of `x` along `axis` at `index` (an [n, 1] index is [n]); an
    index of several axes gives them all in place of `axis`."""
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    axis = int(axis) % x.dim()
    idx = _index(index, x)
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def gather_nd(x, index, name=None):
    idx = _index(index, x)
    return x[tuple(idx[..., i] for i in range(idx.shape[-1]))]


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def index_sample(x, index):
    return torch.take_along_dim(x, _index(index, x), dim=1)


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, _index(indices, x), dim=axis)


def scatter(x, index, updates, overwrite=True, name=None):
    """`x` with the rows at `index` set to `updates`; with
    ``overwrite=False`` those rows are zeroed and then every update at
    an index summed into its row."""
    idx = _index(index, x)
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    if overwrite:
        return x.index_put((idx,), updates)
    return x.index_put((idx,), torch.zeros_like(updates)).index_put(
        (idx,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    idx = _index(index, x)
    return x.index_put(tuple(idx[..., i] for i in range(idx.shape[-1])),
                       updates, accumulate=True)


def put_along_axis(x, indices, values, axis, reduce="assign"):
    idx = _index(indices, x)
    vals = values if isinstance(values, torch.Tensor) else torch.full(
        idx.shape, values, dtype=x.dtype, device=x.device)
    vals = vals.to(x.dtype).expand(idx.shape)
    if reduce == "add":
        return x.scatter_add(axis, idx, vals)
    return x.scatter(axis, idx, vals)


_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad by (before, after) pairs: one per axis when `pad` has 2 x ndim
    entries, else paddle's convention, the last spatial axis's pair first
    (for NCHW ``[left, right, top, bottom]``)."""
    pad = _ints(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(pad) // 2
        spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
        spatial.reverse()
        if data_format.endswith("C"):
            pairs = [(0, 0)] * (nd - n_spatial - 1) + spatial + [(0, 0)]
        else:
            pairs = [(0, 0)] * (nd - n_spatial) + spatial
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    # PyTorch pads only the last 1-3 axes of [N, C, ...] in these modes:
    # merge the unpadded leading axes into the channel axis
    first = builtins.min((i for i, p in enumerate(pairs) if p != (0, 0)),
                         default=nd - 1)
    lead = tuple(x.shape[:first])
    body = x.reshape((1, int(np.prod(lead)) if lead else 1)
                     + tuple(x.shape[first:]))
    flat = [p for pair in reversed(pairs[first:]) for p in pair]
    out = torch.nn.functional.pad(body, flat, mode=_PAD_MODES[mode])
    return out.reshape(lead + tuple(out.shape[2:]))


def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, x % shard_size,
                       torch.full_like(x, ignore_value))


def one_hot(x, num_classes, name=None):
    """float32 rows of `num_classes`; an index out of range gives a row of
    zeros."""
    x = tensor_like(x, None, "one_hot")
    return (x.unsqueeze(-1) == torch.arange(
        num_classes, device=x.device)).to(torch.float32)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


__all__ = ["as_complex", "as_real", "broadcast_tensors", "broadcast_to",
           "cast", "chunk", "concat", "expand", "expand_as", "flatten",
           "flip", "gather", "gather_nd", "getitem", "index_sample",
           "index_select", "moveaxis", "one_hot", "pad", "put_along_axis",
           "repeat_interleave", "reshape", "roll", "rot90", "scatter",
           "scatter_nd_add", "shard_index", "slice", "split", "squeeze",
           "stack", "strided_slice", "swapaxes", "take_along_axis", "tile",
           "transpose", "unbind", "unsqueeze", "unstack"]
