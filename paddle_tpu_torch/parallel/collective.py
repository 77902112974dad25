"""The eager collectives over a mesh axis
(``paddle_tpu/parallel/collective.py``).

A tensor is a global value; its per-rank views are its pieces along the
group's axis.  As the JAX package's ``_over_mesh`` does, a tensor whose
dim 0 the group's size divides is split on dim 0, rank ``r`` holding
piece ``r``, and any other tensor is replicated, every rank holding all
of it; the result is assembled the same way (the pieces of a split input
concatenated on dim 0, one rank's value of a replicated one).  So an
``all_reduce`` of a replicated tensor multiplies it by the group's size,
as N ranks each holding the value would.  Rank ``r`` computes on the
mesh's device along the group's axis (every other axis at 0), and every
reduction sums in rank order.  Point-to-point calls keep the JAX
package's mailbox: ``send`` posts a copy, ``recv`` takes it.
"""
import torch

from . import env as _env


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Group:
    """A named axis of a mesh and the ranks along it."""

    def __init__(self, rank, nranks, id=0, ranks=None, mesh=None,
                 axis="data"):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.ranks = ranks or list(range(nranks))
        self.mesh = mesh
        self.axis = axis

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(rank={self.rank}, nranks={self.nranks}, "
                f"axis={self.axis})")


_default_group = None
_group_counter = [0]
_GROUPS = {}


def _get_default_group():
    global _default_group
    mesh = _env.global_mesh()
    if _default_group is None or _default_group.mesh is not mesh:
        axis = mesh.axis_names[0]
        _default_group = Group(_env.get_rank(), mesh.shape[axis], id=0,
                               mesh=mesh, axis=axis)
    return _default_group


def new_group(ranks=None, backend=None, timeout=None):
    """A group over the global mesh's first axis; `ranks` records its
    membership."""
    _group_counter[0] += 1
    mesh = _env.global_mesh()
    n = len(ranks) if ranks else _env.get_world_size()
    g = Group(_env.get_rank(), n, id=_group_counter[0], ranks=ranks,
              mesh=mesh, axis=mesh.axis_names[0])
    _GROUPS[g.id] = g
    return g


def get_group(id=0):
    """The group registered under `id`, the default group for 0, None for
    an unknown id."""
    if id == 0:
        return _get_default_group()
    return _GROUPS.get(id)


def _group_info(group):
    g = group or _get_default_group()
    return g, g.axis, g.nranks


def _rank_devices(g, n, x):
    """The device rank ``r`` of group `g` computes on: the mesh's device
    along the group's axis, where the mesh has that axis at size `n`;
    else the input's own device."""
    mesh = g.mesh or _env.global_mesh()
    if mesh.shape.get(g.axis) == n:
        return mesh.axis_devices(g.axis)
    return (x.device,) * n


def _over_mesh(fn, x, group):
    """``fn(pieces, devices)`` over the group's ranks: the input split on
    dim 0 when the group's size divides it, else replicated; `fn` returns
    each rank's output, assembled as the input was."""
    g, axis, n = _group_info(group)
    split = x.dim() > 0 and x.shape[0] % n == 0
    pieces = list(x.chunk(n)) if split else [x] * n
    devices = _rank_devices(g, n, x)
    outs = fn([p.to(d) for p, d in zip(pieces, devices)], devices)
    if split:
        return torch.cat([o.to(x.device) for o in outs])
    return outs[0].to(x.device)


def _sum(vals, dev):
    acc = vals[0].to(dev)
    for v in vals[1:]:
        acc = acc + v.to(dev)
    return acc


def _reduce(op, vals, dev):
    if op == ReduceOp.SUM:
        return _sum(vals, dev)
    if op == ReduceOp.AVG:
        return _sum(vals, dev) / len(vals)
    if op == ReduceOp.PROD:      # the JAX package's exp(psum(log v))
        return torch.exp(_sum([torch.log(v) for v in vals], dev))
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        pick = torch.maximum if op == ReduceOp.MAX else torch.minimum
        acc = vals[0].to(dev)
        for v in vals[1:]:
            acc = pick(acc, v.to(dev))
        return acc
    raise ValueError(f"unknown ReduceOp {op}")


def _assign(tensor, value):
    """`tensor` holding `value` (a collective's result may change its
    shape)."""
    with torch.no_grad():
        if value.shape == tensor.shape and value.dtype == tensor.dtype:
            tensor.copy_(value)
        else:
            tensor.data = value
    return tensor


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    out = _over_mesh(lambda vals, devs: [_reduce(op, vals, d) for d in devs],
                     tensor, group)
    return _assign(tensor, out)


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """On a mesh the result lands on every rank: `all_reduce`."""
    return all_reduce(tensor, op=op, group=group)


def broadcast(tensor, src, group=None, sync_op=True):
    """A split input becomes `src`'s piece on every rank (a rank outside
    the group clamps to the first); a replicated one is already
    consistent."""
    g, axis, n = _group_info(group)
    x = tensor
    if x.dim() and x.shape[0] % n == 0 and n > 1:
        shard = x.shape[0] // n
        src_local = g.get_group_rank(src) if g.ranks else src
        start = min(max(src_local * shard, 0), x.shape[0] - shard)
        block = x[start:start + shard]
        return _assign(tensor, torch.cat([block] * n))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's piece concatenated, on every rank: the output holds
    the group's size copies of the input, and `tensor_list` (when given)
    gets them one by one."""
    g, axis, n = _group_info(group)
    out = _over_mesh(
        lambda vals, devs: [torch.cat([v.to(d) for v in vals]) for d in devs],
        tensor, group)
    if tensor_list is not None:
        per = out.shape[0] // n
        for i in range(n):
            tensor_list.append(out[i * per:(i + 1) * per])
    return out


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Each rank's piece split again into the group's size parts, rank
    ``r`` keeping the sum over ranks of their part ``r`` (a sum whatever
    `op`, as in the JAX package)."""
    g, axis, n = _group_info(group)
    if isinstance(tensor_list, (list, tuple)):
        data = torch.cat(list(tensor_list))
    else:
        data = tensor if tensor_list is None else tensor_list
    if not (data.dim() and data.shape[0] % n == 0):
        raise ValueError(f"reduce_scatter: dim 0 of shape "
                         f"{tuple(data.shape)} does not split over {n} ranks")

    def scatter_sum(vals, devs):
        if vals[0].shape[0] % n:
            raise ValueError(f"reduce_scatter: a rank's piece of "
                             f"{vals[0].shape[0]} rows does not split over "
                             f"{n} ranks")
        return [_sum([v.chunk(n)[r] for v in vals], d)
                for r, d in enumerate(devs)]

    return _assign(tensor, _over_mesh(scatter_sum, data, group))


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """This process's rank takes its entry of `tensor_list`."""
    g, axis, n = _group_info(group)
    if tensor_list:
        data = torch.stack(list(tensor_list))
        rank = g.rank if g.ranks is None else g.get_group_rank(g.rank)
        _assign(tensor, data[max(rank, 0)])
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """A tensor: each rank's piece split on dim 1 into the group's size
    parts, rank ``r`` receiving part ``r`` of every rank, concatenated on
    dim 0 in rank order.  A list (the same on every rank): this process's
    rank receives its entry from every peer."""
    g, axis, n = _group_info(group)
    if isinstance(in_tensor_list, torch.Tensor):
        def exchange(vals, devs):
            return [torch.cat([v.chunk(n, dim=1)[r].to(d) for v in vals])
                    for r, d in enumerate(devs)]

        return _over_mesh(exchange, in_tensor_list, group)
    r = max(g.rank if g.ranks is None else g.get_group_rank(g.rank), 0)
    received = [in_tensor_list[r] for _ in range(n)]
    if out_tensor_list is not None:
        out_tensor_list.extend(received)
        return out_tensor_list
    return received


_mailbox = {}


def send(tensor, dst=0, group=None, sync_op=True):
    """Posts a copy of `tensor` to `dst`'s mailbox."""
    _mailbox.setdefault(dst, []).append(tensor.detach().clone())
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Takes the oldest post to this rank (else to `src`) into `tensor`;
    with none, `tensor` keeps its value."""
    box = _mailbox.get(_env.get_rank()) or _mailbox.get(src)
    if box:
        _assign(tensor, box.pop(0).to(tensor.device))
    return tensor


class _DoneTask:
    def wait(self):
        return True

    def is_completed(self):
        return True


def isend(tensor, dst=0, group=None):
    send(tensor, dst, group)
    return _DoneTask()


def irecv(tensor, src=0, group=None):
    recv(tensor, src, group)
    return _DoneTask()


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    return [op.op(op.tensor, op.peer, op.group) for op in p2p_op_list]


def barrier(group=None):
    """Waits for the work queued on every card of the group's mesh."""
    g = group or _get_default_group()
    mesh = g.mesh or _env.global_mesh()
    for d in mesh.distinct_devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def wait(tensor, group=None, use_calc_stream=True):
    """Waits for the work queued on `tensor`'s card."""
    if isinstance(tensor, torch.Tensor) and tensor.device.type == "cuda":
        torch.cuda.synchronize(tensor.device)
    return tensor
