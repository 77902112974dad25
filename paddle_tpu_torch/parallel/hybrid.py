"""The train step (``paddle_tpu/parallel/hybrid.py::CompiledTrainStep``)
over a mesh of ``data``, ``model``, ``seq`` and ``expert`` axes, at
ZeRO stages 0-3; `TrainStep` is its case without a mesh (one shard on
one device).

One process drives every shard, as the JAX package's one controller
does.  Each parameter's ``dist_spec`` (cleaned against the mesh:
unknown axes, axes of size 1 and dims they do not divide fall back to
whole) shards it over ``model`` or ``expert``; every combination of
those ranks (a "combo") owns its local shards, and the replicated
parameters once more, under one flat layout of the local shapes.  Data
shard ``r`` takes its slice of the batch (dim 0 split when dp divides
it, the whole batch otherwise; an integer [B, L] value split so also
splits dim 1 over ``seq``, and a live ``seq`` axis with no such value
raises).  The ranks of one data shard (``model`` x ``seq`` x
``expert``, rank ``g`` on the mesh's device at its coordinates) run as
one group over per-rank lists (``distributed.spmd``), each through its
own replica of the model holding its combo's tensors; one
``torch.autograd.grad`` of the sum of the group's losses gives every
rank its gradients (never into a shared ``.grad``: shards on one device
share one set of tensors).  A one-rank group calls the model on tensors.
The gradients are meaned over a combo's ranks (its ``seq`` ranks, as
JAX's pmean; and the equal copies of an axis nothing shards, where each
JAX device keeps its own) and then over ``data``:

- stage 0: in shard order on the combo's first device, then each device
  runs the optimizer's per-parameter ``fused_update`` with its own copy
  of the state; the mean gradient stays in each parameter's ``.grad``
  until the next step;
- stages 1 and 2 (they coincide, as in JAX: the reduced gradient is
  never stored): a combo's parameters are flattened in sorted name
  order (as ``ravel_pytree`` orders a dict), padded with zeros to a
  multiple of ``lcm(dp, 1024)`` and cut into dp equal ranges.  One
  reduce-scatter over the data shards (summed in shard order, divided by
  dp) gives each rank its gradient range; each rank updates its range
  with optimizer state for its range only (`zero_shard_update`), and one
  all-gather writes the new parameters back;
- stage 3: only each rank's parameter range persists between steps; the
  step gathers them before the forward, and `sync_to_model` and
  `state_dict` rebuild the full parameters from every combo's ranges.

The loss is the mean over ``seq`` and then ``data`` (the ``model`` and
``expert`` ranks' losses are equal).  The weight-decay convention is
`make_fused_update`'s (coupled decay adds ``wd * p`` to the gradient,
decoupled decay subtracts ``lr * wd * p_old`` after the update), on
every entry of a range, biases included; a rule that is not elementwise
(Lamb's trust ratio) sees a rank's whole range, not one parameter, at
stages 1-3, as in JAX.  With ``amp_dtype`` the floating parameters of
more than one dimension enter the loss rounded to that dtype (the JAX
step's cast at entry; no autocast).  Dropout draws from a
``torch.Generator`` per rank on its device, seeded from `seed`, the data
index and the ``seq`` index (in place of JAX's key folded with both):
the ``model`` and ``expert`` ranks of a position draw the same masks, as
JAX's shared key gives them.  ``remat=True`` checkpoints each block
(each module of an ``nn.ModuleList`` of the model) across the group's
ranks: its activations are recomputed in the backward from its inputs,
with the dropout masks of the forward.  The learning rate is read before
the update; an ``LRScheduler`` steps after it.  What the JAX step
ignores raises at build: an optimizer's gradient clip, regularizer
object, ``apply_decay_param_fun`` or Lamb exclude function, and a
parameter's own regularizer or learning rate.
"""
import contextlib
import itertools
import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..distributed import spmd
from ..distributed.spmd import swapped
from ..optimizer.lr import LRScheduler
from .env import Mesh

GROUP_AXES = ("model", "seq", "expert")
SHARD_AXES = ("model", "expert")    # the axes a parameter may shard over
_SEED_STRIDE = 0x9E3779B1       # the ranks' generators: seed + i * stride


def refuse_eager_only_params(params, who):
    for n, p in params.items():
        if getattr(p, "regularizer", None) is not None or getattr(
                p, "optimize_attr", {}).get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError(
                f"parameter {n}: a per-parameter regularizer or learning "
                f"rate is not ported to {who} (the JAX compiled step "
                f"ignores both)")


def clean_spec(spec, mesh, shape):
    """`spec` (a tuple of axis names or None per dim) against `mesh`: an
    axis the mesh lacks, of size 1, or not dividing its dim falls back to
    None (whole), as the JAX step's ``_clean_spec`` does."""
    spec = tuple(spec or ())
    axes = spec + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, axes[:len(shape)]):
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        ok = ax is not None and all(a in mesh.shape for a in names)
        if ok:
            size = math.prod(mesh.shape[a] for a in names)
            ok = size > 1 and dim % size == 0
        out.append(ax if ok else None)
    return tuple(out)


def shard_axes_of(specs, who):
    """The mesh axes the cleaned `specs` shard parameters over; only
    ``model`` and ``expert`` may."""
    used = set()
    for n, spec in specs.items():
        for ax in spec:
            if ax is None:
                continue
            if not isinstance(ax, str) or ax not in SHARD_AXES:
                raise NotImplementedError(
                    f"{who}: parameter {n} is sharded over {ax!r}; only "
                    f"{SHARD_AXES} shard parameters")
            used.add(ax)
    return used


def local_shape(shape, spec, mesh):
    return tuple(d // mesh.shape[ax] if ax is not None else d
                 for d, ax in zip(shape, spec))


def shard_of(t, spec, coords, sizes):
    """The shard (a view) of `t` at ``coords`` (``{axis: rank}``) under
    `spec`, over axes of `sizes` (``{axis: size}``)."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            w = t.shape[dim] // sizes[ax]
            t = t.narrow(dim, coords[ax] * w, w)
    return t


def make_fused_update(optimizer):
    """The optimizer's update of one flat buffer with the weight-decay
    convention: coupled decay adds ``wd * p`` to the gradient, decoupled
    decay subtracts ``lr * wd * p_old`` after the update.  Shared by the
    data-parallel and pipelined steps."""
    wd = optimizer.weight_decay
    decoupled = optimizer.decoupled_weight_decay

    def fused_update(pflat, gflat, state, lr):
        if wd and not decoupled:
            gflat = gflat + wd * pflat
        new_p, new_state = optimizer.update(pflat, gflat, state, lr)
        if wd and decoupled:
            new_p = new_p - lr * wd * pflat
        return new_p, new_state

    return fused_update


def zero_shard_update(gshard_sum, dp, pshard, state, lr, fused_update):
    """A rank's ZeRO update: its range of the reduce-scattered gradient
    (`gshard_sum`, the shards' sum in shard order) divided by `dp`, then
    the fused update of its parameter range `pshard` with its state."""
    return fused_update(pshard, gshard_sum / dp, state, lr)


class FlatLayout:
    """The flat buffer of a group of tensors: sorted names, each tensor
    raveled in turn, zeros to a multiple of `align`, cut into `dp` equal
    ranges of ``shard_len``."""

    def __init__(self, shapes, dp, align):
        self.names = sorted(shapes)
        self.shapes = {n: tuple(shapes[n]) for n in self.names}
        self.offsets, off = {}, 0
        for n in self.names:
            self.offsets[n] = off
            off += math.prod(self.shapes[n])
        self.numel = off
        self.pad = (-off) % align
        self.padded = off + self.pad
        self.dp = dp
        self.shard_len = self.padded // dp

    def flatten(self, tensors):
        flat = [tensors[n].reshape(-1) for n in self.names]
        if self.pad:
            flat.append(flat[0].new_zeros(self.pad))
        return torch.cat(flat)

    def views(self, flat):
        return {n: flat[self.offsets[n]:self.offsets[n]
                        + math.prod(self.shapes[n])].view(self.shapes[n])
                for n in self.names}

    def range(self, r):
        return slice(r * self.shard_len, (r + 1) * self.shard_len)


@contextlib.contextmanager
def remat_blocks(model, generators):
    """Every module of an ``nn.ModuleList`` of `model` runs under
    `spmd.checkpoint_ranks` while the context is open, across its peers
    when called on a group's lists, with the tensors they hold at the
    call (the step's swapped-in ones) and `generators` rewound for the
    recompute."""
    blocks = [b for m in model.modules() if isinstance(m, nn.ModuleList)
              for b in m]
    for b in blocks:
        def run(*args, _b=b, _orig=b.forward, **kw):
            _, mods, _ = spmd.ranks_of(_b, args[0])
            return spmd.checkpoint_ranks(mods, generators,
                                         lambda: _orig(*args, **kw))

        b.forward = run
    try:
        yield
    finally:
        for b in blocks:
            del b.forward


def amp_cast(params, amp_dtype):
    """The floating tensors of more than one dimension rounded to
    `amp_dtype` (None: `params` as they are)."""
    if amp_dtype is None:
        return params
    return {n: p.to(amp_dtype) if p.is_floating_point() and p.dim() > 1
            else p for n, p in params.items()}


def seeded_generator(device, seed, index):
    g = torch.Generator(device=device)
    g.manual_seed((seed + index * _SEED_STRIDE) % (1 << 63))
    return g


def shard_generators(devices, seed):
    return [seeded_generator(d, seed, r) for r, d in enumerate(devices)]


def split_batch(batch, dp):
    """Each shard's slice of each batch value: dim 0 split over dp when
    dp divides it, else the whole value (the JAX step's batch specs)."""
    out = [[] for _ in range(dp)]
    for b in batch:
        split = dp > 1 and b.dim() > 0 and b.shape[0] % dp == 0
        pieces = b.chunk(dp) if split else [b] * dp
        for r in range(dp):
            out[r].append(pieces[r])
    return out


def dense_grads(grads):
    """`grads` with each sparse one (``Embedding(sparse=True)``) made
    dense: a compiled step's gradients are dense, as JAX's are under
    tracing."""
    return [g.to_dense() if g is not None and g.is_sparse else g
            for g in grads]


def _moved(t, device):
    """Bytes `t` carries from its device to `device` (0 on one device)."""
    return 0 if t.device == device else t.numel() * t.element_size()


def _size(ts):
    return sum(t.numel() * t.element_size() for t in ts)


class CompiledTrainStep:
    """``loss_fn(model, *batch, generator=...) -> scalar`` over `mesh` (a
    `Mesh` of ``data``, ``model``, ``seq`` and ``expert`` axes; None: one
    shard on `device`, the card unless told).  With a live ``model``,
    ``seq`` or ``expert`` axis, `loss_fn` gets the model, per-rank lists
    of the batch values and of the generators, and returns per-rank
    losses (GPT's ``loss`` does).  `optimizer` is one of ``optimizer``'s
    update rules.  `zero_stage` (or `zero_shard_states`) resolves as in
    JAX: None means 1 unless ``zero_shard_states`` is False, and with no
    live ``data`` axis it is 0."""

    def __init__(self, model, loss_fn, optimizer, mesh=None, amp_dtype=None,
                 remat=False, zero_shard_states=None, zero_stage=None,
                 seed=0, device=None):
        who = type(self).__name__
        optimizer.refuse_eager_only(who)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_dtype = amp_dtype
        self.remat = bool(remat)
        self.params = dict(model.named_parameters())
        refuse_eager_only_params(self.params, who)
        if mesh is None:
            self.device = resolve_device(device, who)
            for n, p in self.params.items():
                if p.device != self.device:
                    raise ValueError(f"parameter {n} is on {p.device}, the "
                                     f"step on {self.device}")
            mesh = Mesh([self.device], ("data",))
        self.mesh = mesh
        self.dp = mesh.axis_size("data")
        self.seq = mesh.axis_size("seq")
        self.specs = {n: clean_spec(getattr(p, "dist_spec", None), mesh,
                                    p.shape) for n, p in self.params.items()}
        used = shard_axes_of(self.specs, who)
        self.shard_axes = tuple(a for a in mesh.axis_names if a in used)
        self.group_axes = {a: mesh.shape[a] for a in mesh.axis_names
                           if a in GROUP_AXES and mesh.shape[a] > 1}
        self.combos = list(itertools.product(
            *(range(mesh.shape[a]) for a in self.shard_axes)))
        self.groups = [spmd.RankGroup(self.group_axes, [
            self._device_at(r, c) for c in spmd.rank_coords(
                self.group_axes)]) for r in range(self.dp)]
        self.group_size = self.groups[0].size
        # each group rank's combo index (the ranks of one combo differ only
        # along seq and along axes nothing shards)
        self.rank_combo = [self.combos.index(tuple(
            c.get(a, 0) for a in self.shard_axes))
            for c in self.groups[0].coords]
        self.combo_ranks = self.group_size // len(self.combos)
        self.devices = [g.devices[0] for g in self.groups]
        self.device = self.devices[0]
        # each combo's home device per data rank: its seq-0 rank's
        self.combo_devices = [[self._device_at(r, dict(zip(
            self.shard_axes, c))) for r in range(self.dp)]
            for c in self.combos]
        if zero_stage is None:
            zero_stage = 1 if (zero_shard_states is None
                               or zero_shard_states) else 0
        self.zero_stage = int(zero_stage) if self.dp > 1 else 0
        self.zero = self.zero_stage >= 1
        self.local_shapes = {n: local_shape(p.shape, self.specs[n], mesh)
                             for n, p in self.params.items()}
        self.layout = FlatLayout(self.local_shapes, self.dp,
                                 int(np.lcm(self.dp, 1024)))
        self._buffers = dict(model.named_buffers())
        self._model_device = next(iter(self.params.values())).device \
            if self.params else self.device
        self.generators = [[seeded_generator(
            d, seed, r * self.seq + grp.coord(g, "seq"))
            for g, d in enumerate(grp.devices)] for r, grp in
            enumerate(self.groups)]
        self.replicas = spmd.replicas(model, self.group_size)
        self.step_count = 0
        self.moved_bytes = 0
        self.group_bytes = {}
        with torch.no_grad():
            if self.zero_stage >= 3:
                self.pshards = []
                for c in range(len(self.combos)):
                    flat = self.layout.flatten(
                        {n: v.float() for n, v in self._local(c).items()})
                    self.pshards.append([
                        flat[self.layout.range(r)].to(d).clone()
                        for r, d in enumerate(self.combo_devices[c])])
                self._leaves = None
            else:
                self.pshards = None
                self._leaves = [{d: self._leaves_on(c, d)
                                 for d in self._combo_rank_devices(c)}
                                for c in range(len(self.combos))]
            if self.zero:
                self.opt_state = [[optimizer.init_state(torch.zeros(
                    self.layout.shard_len, dtype=torch.float32, device=d))
                    for d in devs] for devs in self.combo_devices]
            else:
                self.opt_state = [{d: {n: optimizer.init_state(p.detach())
                                       for n, p in own.items()}
                                   for d, own in leaves.items()}
                                  for leaves in self._leaves]
        self._fused_update = make_fused_update(optimizer)

    # ---- placement ----
    def _device_at(self, r, coords):
        """The mesh's device at data index `r` and `coords` (the other
        axes at 0)."""
        at = {a: v for a, v in coords.items() if a in self.mesh.shape}
        if "data" in self.mesh.shape:
            at["data"] = r
        return self.mesh.device(**at)

    def _combo_rank_devices(self, c):
        """The distinct devices of the ranks computing with combo `c`."""
        return list(dict.fromkeys(
            grp.devices[g] for grp in self.groups
            for g in range(grp.size) if self.rank_combo[g] == c))

    def _local(self, c):
        """Combo `c`'s shards of the model's parameters (views)."""
        co = dict(zip(self.shard_axes, self.combos[c]))
        return {n: shard_of(p.detach(), self.specs[n], co, self.mesh.shape)
                for n, p in self.params.items()}

    def _leaves_on(self, c, d):
        """The parameter tensors combo `c`'s ranks on `d` compute with: the
        model's own where they are whole and on its device, a copy (a
        leaf that requires grad) otherwise."""
        if len(self.combos) == 1 and d == self._model_device:
            return dict(self.params)
        return {n: v.to(d).clone().requires_grad_(True)
                for n, v in self._local(c).items()}

    def _gathered_leaves(self):
        """Stage 3: each combo's local parameters on each device of its
        ranks, gathered from its ranges (the all-gather before use)."""
        out = []
        for c, shards in enumerate(self.pshards):
            per = {}
            for d in self._combo_rank_devices(c):
                self.moved_bytes += sum(_moved(s, d) for s in shards)
                flat = torch.cat([s.to(d) for s in shards])
                per[d] = {n: v.detach().requires_grad_(True)
                          for n, v in self.layout.views(flat).items()}
            out.append(per)
        return out

    def persistent_bytes(self):
        """What each rank owns between steps, in bytes: ``params``,
        ``grads`` (the stage-0 mean gradients in ``.grad``) and
        ``optimizer`` state, one dict per data shard and combo (data
        shard major)."""
        out = []
        local = _size(self._local(0).values())
        for r in range(self.dp):
            for c in range(len(self.combos)):
                if self.zero:
                    opt = _size(self.opt_state[c][r].values())
                else:
                    d = self.combo_devices[c][r]
                    st = self.opt_state[c].get(d) or next(iter(
                        self.opt_state[c].values()))
                    opt = _size(v for s in st.values() for v in s.values())
                out.append(dict(
                    params=(_size([self.pshards[c][r]])
                            if self.zero_stage >= 3 else local),
                    grads=local if not self.zero else 0, optimizer=opt))
        return out

    def collective_bytes(self):
        """Bytes each rank sends per step in ring collectives of its
        float32 buffers over ``data``: an all-reduce of the gradients at
        stage 0, a reduce-scatter of the gradients and an all-gather of
        the parameters at stages 1-3 (the same volume), and the loss."""
        dp = self.dp
        if dp == 1:
            return 0
        n = self.layout.padded if self.zero else self.layout.numel
        return int(2 * (dp - 1) / dp * n * 4) + 2 * 4

    def collective_bytes_by_axis(self):
        """Bytes sent per step by axis, summed over every rank: ``data``
        by `collective_bytes` (and the ``seq`` mean of the gradients, a
        ring all-reduce of each rank's local flat gradient), the group
        axes as the last step's collectives counted them."""
        ranks = self.dp * self.group_size
        out = {"data": self.collective_bytes() * ranks}
        if self.seq > 1:
            out["seq"] = int(2 * (self.seq - 1) / self.seq
                             * self.layout.numel * 4) * ranks
        for ax, n in self.group_bytes.items():
            out[ax] = out.get(ax, 0) + n
        return out

    # ---- the loss and the gradients ----
    def _rank_batches(self, batch):
        """``[data shard][group rank]`` lists of the batch values on each
        rank's device: dim 0 split over ``data`` (`split_batch`), and an
        integer [B, L] value split so also split on dim 1 over ``seq``."""
        pieces = split_batch(batch, self.dp)
        split_seq = [
            self.seq > 1 and "data" in self.mesh.shape and b.dim() == 2
            and not b.is_floating_point() and b.shape[0] % self.dp == 0
            and b.shape[1] % self.seq == 0 for b in batch]
        if self.seq > 1 and not any(split_seq):
            raise ValueError(
                "mesh has a 'seq' axis but no batch input is sharded on it; "
                "the model would run ring/Ulysses attention over replicated "
                "full sequences and compute garbage. Shard a batch dim on "
                "'seq', or drop the axis from the mesh.")
        out = []
        for r, grp in enumerate(self.groups):
            ranks = []
            for g, d in enumerate(grp.devices):
                s = grp.coord(g, "seq")
                vals = [b.chunk(self.seq, 1)[s] if cut else b
                        for b, cut in zip(pieces[r], split_seq)]
                self.moved_bytes += sum(_moved(b, d) for b in vals)
                ranks.append([b.to(d) for b in vals])
            out.append(ranks)
        return out

    def _as_tensors(self, batch):
        return tuple(b if isinstance(b, torch.Tensor) else
                     torch.as_tensor(np.asarray(b)) for b in batch)

    def _uses(self, leaves):
        use = dict(amp_cast(leaves, self.amp_dtype))
        dev = next(iter(leaves.values())).device if leaves else self.device
        use.update({n: b.to(dev) for n, b in self._buffers.items()})
        return use

    def _group_losses(self, r, leaves, batches):
        """Data shard `r`'s per-rank losses (float32, autograd recording)
        with each rank computing on its combo's `leaves` on its device."""
        grp, gens = self.groups[r], self.generators[r]
        uses = [self._uses(leaves[self.rank_combo[g]][d])
                for g, d in enumerate(grp.devices)]
        ctx = (remat_blocks(self.model, gens) if self.remat
               else contextlib.nullcontext())
        if grp.size == 1:
            with ctx, swapped(self.model, uses[0]):
                out = [self.loss_fn(self.model, *batches[0],
                                    generator=gens[0])]
        else:
            args = [list(col) for col in zip(*batches)]
            with spmd.scope(grp, self.replicas), \
                    spmd.swapped_all(self.replicas, uses), ctx:
                out = self.loss_fn(self.model, *args, generator=gens)
        return [x.float() for x in out]

    def _reported(self, r, losses):
        """The shard's loss: the mean over ``seq`` of the ranks at
        ``model`` and ``expert`` 0."""
        grp = self.groups[r]
        sel = [losses[g] for g in range(grp.size)
               if all(v == 0 for a, v in grp.coords[g].items()
                      if a != "seq")]
        return _mean([x.to(self.devices[r]) for x in sel])

    def loss(self, *batch):
        """The mean of the shards' losses at the current parameters, in
        float32, with autograd recording: the forward half of a step."""
        leaves = (self._gathered_leaves() if self.zero_stage >= 3
                  else self._leaves)
        batches = self._rank_batches(self._as_tensors(batch))
        return _mean([self._reported(r, self._group_losses(
            r, leaves, batches[r])).to(self.device) for r in range(self.dp)])

    def _grads(self, batch, on_shard):
        """Each data shard's losses and gradients in turn (its activations
        freed before the next): ``on_shard(r, grads)`` takes, per combo,
        the gradients by name meaned over the combo's ranks (``seq``, and
        an axis nothing shards; zeros off the loss's
        path, as ``jax.value_and_grad`` gives them).  Returns the
        shards' reported losses."""
        leaves = (self._gathered_leaves() if self.zero_stage >= 3
                  else self._leaves)
        batches = self._rank_batches(self._as_tensors(batch))
        names = self.layout.names
        self.group_bytes = {}
        losses = []
        for r, grp in enumerate(self.groups):
            gens = self.generators[r]
            per_rank = self._group_losses(r, leaves, batches[r])
            after = [g.get_state() for g in gens] if self.remat else None
            keys = list(dict.fromkeys((self.rank_combo[g], d)
                                      for g, d in enumerate(grp.devices)))
            ps = [leaves[c][d][n] for c, d in keys for n in names]
            total = per_rank[0]
            for x in per_rank[1:]:
                total = total + x.to(total.device)
            grp.sent.clear()
            gs = dense_grads(torch.autograd.grad(total, ps,
                                                 allow_unused=True))
            for ax, n in grp.sent.items():
                self.group_bytes[ax] = self.group_bytes.get(ax, 0) + n
            if after is not None:       # the recompute rewound them
                for g, s in zip(gens, after):
                    g.set_state(s)
            by_combo = {}
            for i, (c, d) in enumerate(keys):
                home = self.combo_devices[c][r]
                got = {n: torch.zeros_like(p) if g is None else g
                       for n, p, g in zip(names, ps[i * len(names):],
                                          gs[i * len(names):(i + 1)
                                             * len(names)])}
                if c in by_combo:
                    self.moved_bytes += sum(_moved(g, home)
                                            for g in got.values())
                    by_combo[c] = {n: by_combo[c][n] + g.to(home)
                                   for n, g in got.items()}
                else:
                    by_combo[c] = {n: g.to(home) for n, g in got.items()}
            # a combo's ranks (its seq ranks, and the ranks of an axis
            # nothing shards) hold equal copies: the mean of their sum
            if self.combo_ranks > 1:
                by_combo = {c: {n: g / self.combo_ranks
                                for n, g in gc.items()}
                            for c, gc in by_combo.items()}
            on_shard(r, by_combo)
            losses.append(self._reported(r, [x.detach() for x in per_rank]))
            del total, gs, per_rank
        return leaves, losses

    # ---- the step ----
    def step(self, *batch):
        """One training step; returns the loss before the update (a 0-d
        float32 tensor on the first shard's device, not synchronised)."""
        self.moved_bytes = 0
        lr = self.optimizer.get_lr()
        if self.zero:
            losses = self._zero_step(batch, lr)
        else:
            losses = self._replicated_step(batch, lr)
        if isinstance(self.optimizer.learning_rate, LRScheduler):
            self.optimizer.learning_rate.step()
        self.step_count += 1
        return _mean([x.to(self.device) for x in losses])

    def _replicated_step(self, batch, lr):
        """Stage 0: per combo, the per-parameter mean in shard order on its
        first device, copied to each of its devices, and each device's own
        update."""
        acc = [{} for _ in self.combos]

        def add(r, by_combo):
            for c, grads in by_combo.items():
                home = self.combo_devices[c][0]
                for n, g in grads.items():
                    self.moved_bytes += _moved(g, home)
                    g = g.to(home)
                    acc[c][n] = g if r == 0 else acc[c][n] + g

        for per in self._leaves:
            for own in per.values():
                for p in own.values():
                    p.grad = None
        leaves, losses = self._grads(batch, add)
        with torch.no_grad():
            for c, per in enumerate(leaves):
                mean = {n: g / self.dp if self.dp > 1 else g
                        for n, g in acc[c].items()}
                for d, own in per.items():
                    grads = {n: g.to(d) for n, g in mean.items()}
                    self.moved_bytes += sum(_moved(g, d)
                                            for g in mean.values())
                    new, self.opt_state[c][d] = self.optimizer.fused_update(
                        {n: p.detach() for n, p in own.items()}, grads,
                        self.opt_state[c][d], lr)
                    for n, p in own.items():
                        p.copy_(new[n])
                        p.grad = grads[n]
        return losses

    def _zero_step(self, batch, lr):
        """Stages 1-3, per combo: the reduce-scatter of the flat gradients
        (each rank's range summed over the shards in shard order), each
        rank's range update, and the all-gather of the new parameters
        (stage 3 keeps the ranges)."""
        lay = self.layout
        sums = [[None] * self.dp for _ in self.combos]

        def scatter(r_src, by_combo):
            for c, grads in by_combo.items():
                gflat = lay.flatten(grads)
                for r, d in enumerate(self.combo_devices[c]):
                    piece = gflat[lay.range(r)]
                    self.moved_bytes += _moved(piece, d)
                    piece = piece.to(d)
                    sums[c][r] = piece if r_src == 0 else sums[c][r] + piece

        leaves, losses = self._grads(batch, scatter)
        with torch.no_grad():
            for c, devs in enumerate(self.combo_devices):
                if self.zero_stage >= 3:
                    pshards = self.pshards[c]
                else:
                    flats = {d: lay.flatten({n: p.detach()
                                             for n, p in own.items()})
                             for d, own in leaves[c].items()}
                    pshards = [flats.get(d, next(iter(flats.values())))[
                        lay.range(r)].to(d) for r, d in enumerate(devs)]
                new = []
                for r in range(self.dp):
                    p_new, self.opt_state[c][r] = zero_shard_update(
                        sums[c][r], self.dp, pshards[r],
                        self.opt_state[c][r], lr, self._fused_update)
                    new.append(p_new)
                if self.zero_stage >= 3:
                    self.pshards[c] = new
                    continue
                for d, own in leaves[c].items():
                    self.moved_bytes += sum(_moved(s, d) for s in new)
                    views = lay.views(torch.cat([s.to(d) for s in new]))
                    for n, p in own.items():
                        p.copy_(views[n])
                        p.grad = None
        return losses

    # ---- inspection ----
    def cost_analysis(self, *batch):
        """``{"flops": ...}`` of data shard 0's forward and backward (its
        whole group), counted by ``torch.utils.flop_counter.
        FlopCounterMode`` (no update; the generators are left as they
        were)."""
        from torch.utils.flop_counter import FlopCounterMode

        gens = self.generators[0]
        states = [g.get_state() for g in gens]
        leaves = (self._gathered_leaves() if self.zero_stage >= 3
                  else self._leaves)
        b0 = self._rank_batches(self._as_tensors(batch))[0]
        with FlopCounterMode(display=False) as fc:
            losses = self._group_losses(0, leaves, b0)
            ps = [p for per in leaves for own in per.values()
                  for p in own.values()]
            torch.autograd.grad(_mean(losses), ps, allow_unused=True)
        for g, s in zip(gens, states):
            g.set_state(s)
        return {"flops": float(fc.get_total_flops())}

    def memory_analysis(self, *batch):
        """The peak bytes allocated on the first shard's card over every
        shard's forward and backward (the step without its reduction and
        update, which leaves the state as it was); None on the CPU."""
        if self.device.type != "cuda":
            return None
        states = [[g.get_state() for g in gens] for gens in self.generators]
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self._grads(batch, lambda r, grads: None)
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        for gens, st in zip(self.generators, states):
            for g, s in zip(gens, st):
                g.set_state(s)
        return peak

    def full_params(self):
        """``{name: tensor}`` of the current parameters, each rebuilt from
        its combos' shards (and gathered at stage 3), on the first
        shard's device."""
        if self.zero_stage >= 3:
            local = []
            for shards in self.pshards:
                flat = torch.cat([s.to(self.device) for s in shards])
                local.append({n: v.clone() for n, v in
                              self.layout.views(flat).items()})
        else:
            local = [{n: p.detach() for n, p in (
                per.get(self.device) or next(iter(per.values()))).items()}
                for per in self._leaves]
        if len(self.combos) == 1:
            return {n: v.to(self.device) for n, v in local[0].items()}
        out = {}
        for n, p in self.params.items():
            spec = self.specs[n]
            if all(a is None for a in spec):
                out[n] = local[0][n].to(self.device)
                continue
            full = torch.empty(p.shape, dtype=local[0][n].dtype,
                               device=self.device)
            for c, co in enumerate(self.combos):
                shard_of(full, spec, dict(zip(self.shard_axes, co)),
                         self.mesh.shape).copy_(local[c][n])
            out[n] = full
        return out

    def sync_to_model(self):
        """The model's parameters hold the step's current values."""
        with torch.no_grad():
            for n, v in self.full_params().items():
                p = self.params[n]
                if v.data_ptr() != p.data_ptr():    # not the model's own
                    p.copy_(v.to(p.device))

    def state_dict(self):
        self.sync_to_model()
        return self.model.state_dict()


def _mean(losses):
    total = losses[0]
    for x in losses[1:]:
        total = total + x
    return total / len(losses) if len(losses) > 1 else total


class TrainStep(CompiledTrainStep):
    """`CompiledTrainStep` without a mesh: one shard on `device` (None
    means the card; without one it raises), whose parameters are the
    model's own and must lie there."""

    def __init__(self, model, loss_fn, optimizer, amp_dtype=None, seed=0,
                 device=None, remat=False):
        super().__init__(model, loss_fn, optimizer, mesh=None,
                         amp_dtype=amp_dtype, remat=remat, seed=seed,
                         device=device)
