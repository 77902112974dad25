"""Where a tensor-parallel tensor splits, and the moves between a whole
tensor and its head shards (``paddle_tpu/parallel/sharding_annotations.py``
names the same facts as PartitionSpecs).

A sharded tensor is a list of `tp` contiguous tensors, shard ``i`` on
``mesh.devices[i]``, each a fresh copy (never a view of the whole), so a
shard's bytes are truly 1/tp.  The head axis is the shard axis of the
whole decode stack: each shard owns ``num_heads / tp`` heads of every
page.
"""
import collections

import torch

HeadSharding = collections.namedtuple("HeadSharding", "axis devices")
HeadSharding.__doc__ = """A tensor's head sharding: the axis its heads
sit on and the shards' devices in order."""


def kv_pool_spec(pool_layout):
    """The head axis of one KV pool: 2 of the token layout ``[P,
    page_size, H, D]``, 0 of the kernel layout ``[H, P, page_size, D]``."""
    return 0 if pool_layout == "kernel" else 2


def kv_scale_spec():
    """The head axis of an int8 pool's ``[P, H]`` scale array, whatever
    the pool layout: 1."""
    return 1


def shard_list(x):
    """A pool-state entry as its list of head shards: a mesh pool's entry
    is that list already, an unsharded pool's one tensor is a list of
    one."""
    return x if isinstance(x, list) else [x]


def shard_heads(x, axis, mesh):
    """`x` split into ``mesh.size`` equal contiguous pieces along `axis`,
    piece ``i`` a fresh tensor on ``mesh.devices[i]``.  ValueError when
    the axis does not divide."""
    n = mesh.size
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} is not divisible by "
                         f"tp_degree={n}")
    step = size // n
    out = []
    for i, dev in enumerate(mesh.devices):
        piece = x.narrow(axis, i * step, step)
        out.append(torch.empty(piece.shape, dtype=x.dtype,
                               device=dev).copy_(piece))
    return out


def gather_heads(shards, axis, device=None):
    """The whole tensor from its shards, concatenated along `axis` on
    `device` (None: the first shard's).  A single shard comes back as it
    is."""
    if len(shards) == 1 and (device is None
                             or shards[0].device == torch.device(device)):
        return shards[0]
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in shards], dim=axis)
