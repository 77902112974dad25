"""One process running a group of SPMD ranks in lockstep.

The JAX package runs a step under ``shard_map``: every device traces the
same program on its own shard, and a collective (``psum``,
``all_gather``, ``ppermute``, ``all_to_all``) joins them mid-forward.
The port drives every shard from one process, so a group of ranks whose
forward needs the others' pieces (the ``model``, ``seq`` and ``expert``
axes of one data shard) runs as ONE forward over per-rank lists: a
layer that takes part in a collective takes a list with one tensor per
rank and returns one, and each collective is a ``torch.autograd.Function``
over the whole list whose backward is the JAX transpose of its forward.
One ``torch.autograd.grad`` of the sum of the ranks' losses then gives
every rank the gradient its device gets in JAX (the cotangent of each
device's own loss is 1 there too).

- `RankGroup`: the ranks (row-major over the group's axes, in mesh
  order), each rank's device, and the collectives over one axis;
  `SOLO` is the group of one rank, where every collective is the
  identity.
- `scope(group, replicas)`: while open, the module trees `replicas` (one
  per rank, each holding its rank's tensors in its slots) are the ranks
  of `group`; `ranks_of(module, x)` gives a module of replica 0 its
  peers.  A list input is the group's; a tensor is one rank's, outside
  any group.
- `swapped`, `replicas` and `checkpoint_ranks`: tensors in a module's
  slots for a while, the per-rank module trees, and activation
  checkpointing of a group's block.

Each rank's pieces stay on its own device: a collective sums, in rank
order, on each receiving rank's device.
"""
import contextlib
import copy
import math
import threading
import weakref

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


class _Collective(torch.autograd.Function):
    """``fwd(list) -> list`` with the backward ``bwd(list of cotangents)
    -> list of input cotangents``; both linear maps over the ranks."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return tuple(fwd(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.bwd(list(gs)))


def _apply(fwd, bwd, xs):
    return list(_Collective.apply(fwd, bwd, *xs))


def rank_coords(axes):
    """``{axis: index}`` of each rank of a group over `axes` (``{name:
    size}``), row-major."""
    names, sizes = tuple(axes), tuple(axes.values())
    return [dict(zip(names, (int(c) for c in np.unravel_index(i, sizes))))
            if names else {} for i in range(math.prod(sizes))]


class RankGroup:
    """The ranks of one group: `axes` ``{name: size}`` in mesh order,
    rank ``i`` at the row-major coordinates of ``i`` over them, on
    ``devices[i]``."""

    def __init__(self, axes, devices):
        self.axes = {a: int(s) for a, s in axes.items()}
        self.coords = rank_coords(self.axes)
        self.size = len(self.coords)
        self.devices = list(devices)
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a group of "
                             f"{self.size} ranks over {self.axes}")
        # bytes the ranks sent, by axis, as ring collectives would
        self.sent = {}

    def _count(self, ax, xs, share):
        n = self.axis_size(ax)
        self.sent[ax] = self.sent.get(ax, 0) + int(sum(
            share(n) * x.numel() * x.element_size() for x in xs))

    def axis_size(self, ax):
        return self.axes.get(ax, 1)

    def coord(self, r, ax):
        return self.coords[r].get(ax, 0)

    def lines(self, ax):
        """The rank lists of a collective over `ax`: ranks that agree on
        every other axis, in `ax` order."""
        out = {}
        for r, c in enumerate(self.coords):
            key = tuple(v for a, v in c.items() if a != ax)
            out.setdefault(key, []).append(r)
        return list(out.values())

    # ---- the collectives; each the identity over an axis of size 1 ----
    def _sum(self, xs, ax):
        self._count(ax, xs, lambda n: 2 * (n - 1) / n)
        out = [None] * len(xs)
        for line in self.lines(ax):
            for r in line:
                d = self.devices[r]
                s = xs[line[0]].to(d)
                for j in line[1:]:
                    s = s + xs[j].to(d)
                out[r] = s
        return out

    def psum(self, xs, ax):
        """The sum over `ax`; its transpose is itself."""
        if self.axis_size(ax) == 1:
            return list(xs)
        return _apply(lambda v: self._sum(v, ax), lambda g: self._sum(g, ax),
                      xs)

    def copy_to(self, xs, ax):
        """Identity forward, the sum over `ax` backward: the entry of a
        tensor-parallel region (Megatron's copy_to_tensor_parallel)."""
        if self.axis_size(ax) == 1:
            return list(xs)
        return _apply(lambda v: [x.view_as(x) for x in v],
                      lambda g: self._sum(g, ax), xs)

    def reduce_from(self, xs, ax):
        """The sum over `ax` forward, identity backward: the exit of a
        tensor-parallel region (reduce_from_tensor_parallel)."""
        if self.axis_size(ax) == 1:
            return list(xs)
        return _apply(lambda v: self._sum(v, ax), lambda g: g, xs)

    def gather_last(self, xs, ax):
        """The ranks' pieces along `ax` concatenated on the last dim
        forward, each rank's own slice of the cotangent backward."""
        if self.axis_size(ax) == 1:
            return list(xs)

        def fwd(v):
            self._count(ax, v, lambda n: n - 1)
            out = [None] * len(v)
            for line in self.lines(ax):
                for r in line:
                    out[r] = torch.cat([v[j].to(v[r].device) for j in line],
                                       -1)
            return out

        def bwd(g):
            out = [None] * len(g)
            for line in self.lines(ax):
                for k, r in enumerate(line):
                    w = g[r].shape[-1] // len(line)
                    out[r] = g[r][..., k * w:(k + 1) * w].contiguous()
            return out

        return _apply(fwd, bwd, xs)

    def pmax(self, xs, ax):
        """The elementwise max over `ax` of detached values."""
        xs = [x.detach() for x in xs]
        if self.axis_size(ax) == 1:
            return xs
        self._count(ax, xs, lambda n: 2 * (n - 1) / n)
        out = [None] * len(xs)
        for line in self.lines(ax):
            for r in line:
                m = xs[line[0]].to(xs[r].device)
                for j in line[1:]:
                    m = torch.maximum(m, xs[j].to(xs[r].device))
                out[r] = m
        return out

    def ppermute(self, xs, ax, shift=1):
        """Rank k of each line receives rank k - shift's value; the
        transpose sends it back."""
        if self.axis_size(ax) == 1:
            return list(xs)

        def perm(v, sh):
            self._count(ax, v, lambda n: 1)
            out = [None] * len(v)
            for line in self.lines(ax):
                n = len(line)
                for k, r in enumerate(line):
                    src = line[(k - sh) % n]
                    out[r] = v[src].to(v[r].device)
            return out

        return _apply(lambda v: perm(v, shift), lambda g: perm(g, -shift),
                      xs)

    def all_to_all(self, xs, ax, split, concat):
        """``jax.lax.all_to_all(..., tiled=True)``: each rank cuts dim
        `split` into one piece per rank of the line, piece k goes to rank
        k, and each rank concatenates what it gets along `concat` in
        rank order.  The transpose swaps `split` and `concat`."""
        if self.axis_size(ax) == 1:
            return list(xs)

        def a2a(v, sp, cc):
            self._count(ax, v, lambda n: (n - 1) / n)
            out = [None] * len(v)
            for line in self.lines(ax):
                n = len(line)
                pieces = {j: v[j].chunk(n, sp) for j in line}
                for k, r in enumerate(line):
                    out[r] = torch.cat([pieces[j][k].to(v[r].device)
                                        for j in line], cc).contiguous()
            return out

        return _apply(lambda v: a2a(v, split, concat),
                      lambda g: a2a(g, concat, split), xs)


SOLO = RankGroup({}, [None])

# the open scope of this thread: (group, {module of replica 0: [its peer
# per rank]}); a recompute in the backward reopens it on its own thread
_local = threading.local()


def current():
    """This thread's open scope, ``(group, peers)``, or None."""
    return getattr(_local, "scope", None)


@contextlib.contextmanager
def reentered(state):
    """The scope `state` (a `current()` value, or None) open on this
    thread while the context is."""
    saved = current()
    _local.scope = state
    try:
        yield
    finally:
        _local.scope = saved


def scope(group, reps):
    """`reps` (one module tree per rank of `group`, replica 0 first) are
    the group's ranks while the context is open."""
    per = [list(r.modules()) for r in reps]
    return reentered((group, {m: [p[i] for p in per]
                              for i, m in enumerate(per[0])}))


def ranks_of(module, x):
    """``(group, per-rank modules, per-rank inputs)`` of a call of
    `module` on `x`: a list `x` is the open group's, with `module`'s
    peers; a tensor (or None) is one rank's, ``(SOLO, [module], [x])``."""
    if isinstance(x, list):
        state = current()
        if state is None or module not in state[1]:
            raise RuntimeError(f"{type(module).__name__} called on a rank "
                               f"list outside a group scope")
        return state[0], state[1][module], x
    return SOLO, [module], [x]


def listed(v, n):
    """`v` as a per-rank list of `n` (a list as it is, anything else
    repeated)."""
    return v if isinstance(v, list) else [v] * n


def unlisted(ys, x):
    """`ys` for a call on `x`: the list in a group, the one value
    outside."""
    return ys if isinstance(x, list) else ys[0]


def replicas(model, n):
    """`n` module trees of `model`'s structure, `model` first: the others
    are deep copies sharing `model`'s parameters and buffers until the
    step swaps each rank's own into its slots."""
    memo = {id(t): t for t in list(model.parameters())
            + list(model.buffers())}
    return [model] + [copy.deepcopy(model, dict(memo)) for _ in range(n - 1)]


_SLOTS = weakref.WeakKeyDictionary()


def _slots(module, names):
    """``(slot table, attribute)`` of each dotted parameter or buffer name
    of `module` (its owner's ``_parameters`` or ``_buffers``), resolved
    once per module and name set."""
    per = _SLOTS.setdefault(module, {})
    if names not in per:
        out = []
        for n in names:
            path, _, attr = n.rpartition(".")
            owner = module.get_submodule(path) if path else module
            table = (owner._parameters if attr in owner._parameters
                     else owner._buffers)
            out.append((table, attr))
        per[names] = out
    return per[names]


@contextlib.contextmanager
def swapped(module, tensors):
    """`module` computing with `tensors` (``{dotted name: tensor}``) in its
    parameter and buffer slots while the context is open, and its own
    after; no other work, so a block's call costs what its forward
    does."""
    slots = _slots(module, tuple(tensors))
    saved = [table[attr] for table, attr in slots]
    for (table, attr), t in zip(slots, tensors.values()):
        table[attr] = t
    try:
        yield
    finally:
        for (table, attr), t in zip(slots, saved):
            table[attr] = t


@contextlib.contextmanager
def swapped_all(mods, tensors):
    """`swapped` of each rank's module with its rank's tensors."""
    with contextlib.ExitStack() as stack:
        for m, t in zip(mods, tensors):
            stack.enter_context(swapped(m, t))
        yield


def checkpoint_ranks(mods, generators, forward, *args):
    """``forward(*args)`` under activation checkpointing over the ranks'
    modules `mods`: the backward recomputes it with the tensors each
    rank's module holds now (inputs of the checkpoint, so gradients
    reach them), the open scope reopened, and each generator of
    `generators` rewound to the state the forward found it in."""
    params = [dict(m.named_parameters()) for m in mods]
    names = [tuple(p) for p in params]
    flat = [t for p in params for t in p.values()]
    gens = [g for g in generators if g is not None]
    states = [g.get_state() for g in gens]
    state = current()
    first = [True]

    def replay(*flat_in):
        if not first[0]:
            for g, s in zip(gens, states):
                g.set_state(s)
        first[0] = False
        held, k = [], 0
        for ns in names:
            held.append(dict(zip(ns, flat_in[k:k + len(ns)])))
            k += len(ns)
        with reentered(state), swapped_all(mods, held):
            return forward(*args)

    return checkpoint(replay, *flat, use_reentrant=False,
                      preserve_rng_state=False)
