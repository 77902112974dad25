"""The train step (``paddle_tpu/parallel/hybrid.py::CompiledTrainStep``)
over the ``data`` axis of a mesh, at ZeRO stages 0-3; `TrainStep` is its
case without a mesh (one shard on one device).

One process drives every data shard, as the JAX package's one
controller does.  Shard ``r`` lives on the mesh's device ``r`` along
``data`` and takes its slice of the batch (dim 0 split when dp divides
it, the whole batch otherwise), computes its own loss and its gradients
with ``torch.autograd.grad`` (never into a shared ``.grad``: shards on
one device share one set of parameter tensors), and then:

- stage 0: the gradients are meaned over the shards in shard order and
  each device runs the optimizer's per-parameter ``fused_update`` with
  its own copy of the state; the mean gradient stays in each
  parameter's ``.grad`` until the next step;
- stages 1 and 2 (they coincide, as in JAX: the reduced gradient is
  never stored): the parameters are flattened in sorted name order (as
  ``ravel_pytree`` orders a dict), padded with zeros to a multiple of
  ``lcm(dp, 1024)`` and cut into dp equal ranges.  One reduce-scatter
  over the shards (summed in shard order, divided by dp) gives each
  rank its gradient range; each rank updates its range with optimizer
  state for its range only (`zero_shard_update`), and one all-gather
  writes the new parameters back;
- stage 3: only each rank's parameter range persists between steps; the
  step gathers them before the forward, and `sync_to_model` and
  `state_dict` rebuild the full parameters.

The loss is the mean over the shards.  The weight-decay convention is
`make_fused_update`'s (coupled decay adds ``wd * p`` to the gradient,
decoupled decay subtracts ``lr * wd * p_old`` after the update), on
every entry of a range, biases included; a rule that is not
elementwise (Lamb's trust ratio) sees a rank's whole range, not one
parameter, at stages 1-3, as in JAX.  With ``amp_dtype`` the floating
parameters of more than one dimension enter the loss rounded to that
dtype (the JAX step's cast at entry; no autocast).  Dropout draws from a
``torch.Generator`` per shard on its device, seeded from `seed` and the
shard's index (in place of JAX's key folded with the data index).
``remat=True`` checkpoints each block (each module of an
``nn.ModuleList`` of the model): its activations are recomputed in the
backward from its inputs, with the dropout masks of the forward.  The
learning rate is read before the update; an ``LRScheduler`` steps after
it.  What the JAX step ignores raises at build: an optimizer's gradient
clip, regularizer object, ``apply_decay_param_fun`` or Lamb exclude
function, and a parameter's own regularizer or learning rate; so do a
``model``, ``seq`` or ``expert`` axis of size > 1 and a parameter whose
``dist_spec`` names one (tensor-parallel training, context parallelism
and experts are not ported).
"""
import contextlib
import math
import weakref

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..optimizer.lr import LRScheduler
from .env import Mesh

REFUSED_AXES = ("model", "seq", "expert")
_SEED_STRIDE = 0x9E3779B1       # the shards' generators: seed + r * stride


def refuse_unported_axes(mesh, params, who):
    """NotImplementedError for a `model`, `seq` or `expert` axis of size
    > 1, or a parameter whose ``dist_spec`` names one."""
    for ax in REFUSED_AXES:
        if mesh.shape.get(ax, 1) > 1:
            raise NotImplementedError(
                f"{who}: a {ax!r} mesh axis of size {mesh.shape[ax]} "
                f"(tensor-parallel training, context parallelism or "
                f"experts) is not ported")
    for n, p in params.items():
        spec = getattr(p, "dist_spec", None) or ()
        named = {a for s in spec if s is not None
                 for a in ((s,) if isinstance(s, str) else s)}
        if named & set(REFUSED_AXES):
            raise NotImplementedError(
                f"{who}: parameter {n} is sharded over {sorted(named)} "
                f"(tensor-parallel training is not ported)")


def refuse_eager_only_params(params, who):
    for n, p in params.items():
        if getattr(p, "regularizer", None) is not None or getattr(
                p, "optimize_attr", {}).get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError(
                f"parameter {n}: a per-parameter regularizer or learning "
                f"rate is not ported to {who} (the JAX compiled step "
                f"ignores both)")


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


def checkpoint_block(block, params, generator, *args, forward=None):
    """``forward(*args)`` (``block``'s own by default) with `params` in
    `block`'s slots, under activation checkpointing: the backward
    recomputes it from `args` and `params` (both inputs of the
    checkpoint, so gradients reach them), and the recompute draws dropout
    from `generator` at the state the forward found it in."""
    forward = forward or block.forward
    names = tuple(params)
    k = len(names)
    state = generator.get_state() if generator is not None else None
    first = [True]

    def replay(*flat):
        if state is not None and not first[0]:
            generator.set_state(state)
        first[0] = False
        with swapped(block, dict(zip(names, flat[:k]))):
            return forward(*flat[k:])

    return checkpoint(replay, *params.values(), *args, use_reentrant=False,
                      preserve_rng_state=False)


@contextlib.contextmanager
def remat_blocks(model, generator):
    """Every module of an ``nn.ModuleList`` of `model` runs under
    `checkpoint_block` while the context is open, with the parameters it
    holds at the call (the step's swapped-in ones)."""
    blocks = [b for m in model.modules() if isinstance(m, nn.ModuleList)
              for b in m]
    for b in blocks:
        def run(*args, _b=b, _orig=b.forward):
            return checkpoint_block(_b, dict(_b.named_parameters()),
                                    generator, *args, forward=_orig)

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


def shard_generators(devices, seed):
    gens = []
    for r, d in enumerate(devices):
        g = torch.Generator(device=d)
        g.manual_seed((seed + r * _SEED_STRIDE) % (1 << 63))
        gens.append(g)
    return gens


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


def _moved(t, device):
    """Bytes `t` carries from its device to `device` (0 on one device)."""
    return 0 if t.device == device else t.numel() * t.element_size()


class CompiledTrainStep:
    """``loss_fn(model, *batch, generator=...) -> scalar`` over the
    ``data`` axis of `mesh` (a `Mesh`; None: one shard on `device`, the
    card unless told).  `optimizer` is one of ``optimizer``'s update
    rules.  `zero_stage` (or `zero_shard_states`) resolves as in JAX:
    None means 1 unless ``zero_shard_states`` is False, and with no live
    ``data`` axis it is 0."""

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
        refuse_unported_axes(mesh, self.params, who)
        self.dp = mesh.axis_size("data")
        self.devices = mesh.axis_devices("data")
        self.device = self.devices[0]
        if zero_stage is None:
            zero_stage = 1 if (zero_shard_states is None
                               or zero_shard_states) else 0
        self.zero_stage = int(zero_stage) if self.dp > 1 else 0
        self.zero = self.zero_stage >= 1
        self.layout = FlatLayout({n: p.shape for n, p in self.params.items()},
                                 self.dp, int(np.lcm(self.dp, 1024)))
        self._buffers = dict(model.named_buffers())
        self._model_device = next(iter(self.params.values())).device \
            if self.params else self.device
        self.generators = shard_generators(self.devices, seed)
        self.generator = self.generators[0]
        self.step_count = 0
        self.moved_bytes = 0
        with torch.no_grad():
            if self.zero_stage >= 3:
                flat = self.layout.flatten(
                    {n: p.detach().float() for n, p in self.params.items()})
                self.pshards = [flat[self.layout.range(r)].to(d).clone()
                                for r, d in enumerate(self.devices)]
                self._leaves = None
            else:
                self.pshards = None
                self._leaves = self._distinct(self._leaves_on)
            if self.zero:
                self.opt_state = [optimizer.init_state(torch.zeros(
                    self.layout.shard_len, dtype=torch.float32, device=d))
                    for d in self.devices]
            else:
                self.opt_state = self._distinct(lambda d: {
                    n: optimizer.init_state(p.detach())
                    for n, p in self._leaves[d].items()})
        self._fused_update = make_fused_update(optimizer)

    # ---- storage ----
    def _distinct(self, fn):
        return {d: fn(d) for d in dict.fromkeys(self.devices)}

    def _leaves_on(self, d):
        """The parameter tensors shards on `d` compute with: the model's
        own on its device, a copy (a leaf that requires grad) on any
        other."""
        if d == self._model_device:
            return dict(self.params)
        return {n: p.detach().to(d).requires_grad_(True)
                for n, p in self.params.items()}

    def _gathered_leaves(self):
        """Stage 3: the full parameters on each distinct device, gathered
        from the ranks' ranges (the all-gather before use)."""
        out = {}
        for d in dict.fromkeys(self.devices):
            self.moved_bytes += sum(_moved(s, d) for s in self.pshards)
            flat = torch.cat([s.to(d) for s in self.pshards])
            out[d] = {n: v.detach().requires_grad_(True)
                      for n, v in self.layout.views(flat).items()}
        return out

    def persistent_bytes(self):
        """What each shard owns between steps, in bytes: ``params``,
        ``grads`` (the stage-0 mean gradients in ``.grad``) and
        ``optimizer`` state, one dict per data shard."""
        def size(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        full = size(self.params.values())
        out = []
        for r, d in enumerate(self.devices):
            if self.zero:
                opt = size(self.opt_state[r].values())
            else:
                opt = size(v for st in self.opt_state[d].values()
                           for v in st.values())
            out.append(dict(
                params=(size([self.pshards[r]]) if self.zero_stage >= 3
                        else full),
                grads=full if not self.zero else 0, optimizer=opt))
        return out

    def collective_bytes(self):
        """Bytes each rank sends per step in ring collectives of its
        float32 buffers: an all-reduce of the gradients at stage 0, a
        reduce-scatter of the gradients and an all-gather of the
        parameters at stages 1-3 (the same volume), and the loss."""
        dp = self.dp
        if dp == 1:
            return 0
        n = self.layout.padded if self.zero else self.layout.numel
        return int(2 * (dp - 1) / dp * n * 4) + 2 * 4

    # ---- the loss and the gradients ----
    def _shard_loss(self, leaves, batch, generator):
        use = dict(amp_cast(leaves, self.amp_dtype))
        dev = next(iter(leaves.values())).device if leaves else self.device
        use.update({n: b.to(dev) for n, b in self._buffers.items()})
        ctx = (remat_blocks(self.model, generator) if self.remat
               else contextlib.nullcontext())
        with ctx, swapped(self.model, use):
            out = self.loss_fn(self.model, *batch, generator=generator)
        return out.float()

    def _shard_batches(self, batch):
        pieces = split_batch(batch, self.dp)
        out = []
        for r, d in enumerate(self.devices):
            self.moved_bytes += sum(_moved(b, d) for b in pieces[r])
            out.append([b.to(d) for b in pieces[r]])
        return out

    def _as_tensors(self, batch):
        return tuple(b if isinstance(b, torch.Tensor) else
                     torch.as_tensor(np.asarray(b)) for b in batch)

    def loss(self, *batch):
        """The mean of the shards' losses at the current parameters, in
        float32, with autograd recording: the forward half of a step."""
        leaves = (self._gathered_leaves() if self.zero_stage >= 3
                  else self._leaves)
        batches = self._shard_batches(self._as_tensors(batch))
        losses = [self._shard_loss(leaves[d], batches[r],
                                   self.generators[r]).to(self.device)
                  for r, d in enumerate(self.devices)]
        return _mean(losses)

    def _grads(self, batch, on_shard):
        """Each shard's loss and gradients in turn (its activations freed
        before the next): ``on_shard(r, grads)`` takes the gradients by
        name (zeros off the loss's path, as ``jax.value_and_grad`` gives
        them).  Returns the shards' losses."""
        leaves = (self._gathered_leaves() if self.zero_stage >= 3
                  else self._leaves)
        batches = self._shard_batches(self._as_tensors(batch))
        names = self.layout.names
        losses = []
        for r, d in enumerate(self.devices):
            gen = self.generators[r]
            loss = self._shard_loss(leaves[d], batches[r], gen)
            after = gen.get_state() if self.remat else None
            ps = [leaves[d][n] for n in names]
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
            if after is not None:       # the recompute rewound it
                gen.set_state(after)
            on_shard(r, {n: torch.zeros_like(p) if g is None else g
                         for n, p, g in zip(names, ps, gs)})
            losses.append(loss.detach())
            del loss, gs
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
        """Stage 0: the per-parameter mean in shard order on the first
        shard's device, copied to every device, and each device's own
        update."""
        acc = {}

        def add(r, grads):
            for n, g in grads.items():
                g = g.to(self.device)
                acc[n] = g if r == 0 else acc[n] + g

        for d, leaves in self._leaves.items():
            for p in leaves.values():
                p.grad = None
        leaves, losses = self._grads(batch, add)
        mean = {n: g / self.dp if self.dp > 1 else g for n, g in acc.items()}
        with torch.no_grad():
            for d, own in leaves.items():
                grads = {n: g.to(d) for n, g in mean.items()}
                self.moved_bytes += sum(_moved(g, d) for g in mean.values())
                new, self.opt_state[d] = self.optimizer.fused_update(
                    {n: p.detach() for n, p in own.items()}, grads,
                    self.opt_state[d], lr)
                for n, p in own.items():
                    p.copy_(new[n])
                    p.grad = grads[n]
        return losses

    def _zero_step(self, batch, lr):
        """Stages 1-3: the reduce-scatter of the flat gradients (each
        rank's range summed over the shards in shard order), each rank's
        range update, and the all-gather of the new parameters (stage 3
        keeps the ranges)."""
        lay = self.layout
        sums = [None] * self.dp

        def scatter(r_src, grads):
            gflat = lay.flatten(grads)
            for r, d in enumerate(self.devices):
                piece = gflat[lay.range(r)]
                self.moved_bytes += _moved(piece, d)
                piece = piece.to(d)
                sums[r] = piece if r_src == 0 else sums[r] + piece

        leaves, losses = self._grads(batch, scatter)
        with torch.no_grad():
            if self.zero_stage >= 3:
                pshards = self.pshards
            else:
                flats = {d: lay.flatten({n: p.detach()
                                         for n, p in own.items()})
                         for d, own in leaves.items()}
                pshards = [flats[d][lay.range(r)]
                           for r, d in enumerate(self.devices)]
            new = []
            for r in range(self.dp):
                p_new, self.opt_state[r] = zero_shard_update(
                    sums[r], self.dp, pshards[r], self.opt_state[r], lr,
                    self._fused_update)
                new.append(p_new)
            if self.zero_stage >= 3:
                self.pshards = new
                return losses
            for d, own in leaves.items():
                self.moved_bytes += sum(_moved(s, d) for s in new)
                views = lay.views(torch.cat([s.to(d) for s in new]))
                for n, p in own.items():
                    p.copy_(views[n])
                    p.grad = None
        return losses

    # ---- inspection ----
    def cost_analysis(self, *batch):
        """``{"flops": ...}`` of one shard's forward and backward, counted
        by ``torch.utils.flop_counter.FlopCounterMode`` on shard 0's
        slice of `batch` (no update; the generator is left as it was)."""
        from torch.utils.flop_counter import FlopCounterMode

        gen = self.generators[0]
        state = gen.get_state()
        leaves = (self._gathered_leaves() if self.zero_stage >= 3
                  else self._leaves)[self.device]
        b0 = self._shard_batches(self._as_tensors(batch))[0]
        with FlopCounterMode(display=False) as fc:
            loss = self._shard_loss(leaves, b0, gen)
            torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        gen.set_state(state)
        return {"flops": float(fc.get_total_flops())}

    def memory_analysis(self, *batch):
        """The peak bytes allocated on the first shard's card over every
        shard's forward and backward (the step without its reduction and
        update, which leaves the state as it was); None on the CPU."""
        if self.device.type != "cuda":
            return None
        states = [g.get_state() for g in self.generators]
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self._grads(batch, lambda r, grads: None)
        torch.cuda.synchronize(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        for g, s in zip(self.generators, states):
            g.set_state(s)
        return peak

    def full_params(self):
        """``{name: tensor}`` of the current parameters (gathered at stage
        3), on the first shard's device."""
        if self.zero_stage >= 3:
            flat = torch.cat([s.to(self.device) for s in self.pshards])
            return {n: v.clone() for n, v in self.layout.views(flat).items()}
        return {n: p.detach() for n, p in self._leaves[self.device].items()}

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
