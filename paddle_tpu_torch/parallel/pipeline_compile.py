"""Pipeline-parallel training over a ``pipe`` mesh axis, composed with
``data`` and ``model`` (``paddle_tpu/parallel/pipeline_compile.py``).

The model's homogeneous blocks (``gpt.blocks.*``) split over ``pipe``:
stage ``s`` of ``S`` holds blocks ``[s L/S, (s+1) L/S)`` on its devices;
everything else (the embeddings, ``ln_f``, the tied head) is replicated
on every stage.  Under a ``model`` axis each parameter is cut by its
``dist_spec`` (``hybrid.clean_spec``) and the ``model`` ranks of a
(stage, data) position run as one group over per-rank lists
(``distributed.spmd``), each through its own replica of the model: the
stage's blocks run their tensor-parallel layers.  The global batch
splits over ``data`` (when ``M dp`` divides it, else each data shard
takes all of it) and each shard's rows into `num_micro` micro-batches.
One process drives every shard: for each data shard, the micro-batches
are issued in the JAX tick order (``M + S - 1`` ticks, stage ``s``
taking micro-batch ``t - s`` at tick ``t``), so across cards each
stage's launches queue on its own card while the next micro-batch
enters; stage 0 embeds, the last stage computes ``head_loss``, and the
activation handed on is cast to ``amp_dtype or float32``, after every
block as at every hand-off (the JAX scan's carry: under AMP the residual
stream is rounded to bf16).  The loss is the mean of the micro-losses
(their sum over M), meaned over ``data``.  The replicated parameters'
gradients are summed over ``pipe``, which gives the tied embedding both
its contributions.

The update is flat per group, stage and ``model`` rank, as in JAX: the
replicated parameters (``other``, in sorted name order) and each stage's
blocks (``block``: for each sorted relative name, the stage's layers
stacked in order), each rank's local shards, padded with zeros to
``lcm(dp, 1024)`` under ZeRO and to 1024 without.  With a live ``data``
axis and ``zero_stage >= 1`` the optimizer state of each group
range-shards over ``data`` through ``hybrid.zero_shard_update``;
otherwise the gradients are meaned over ``data`` and each group updates
whole.  ``remat=True`` (the default) checkpoints each block across the
``model`` ranks, its recompute drawing the forward's dropout masks.
Dropout draws from a ``torch.Generator`` per (stage, data) position,
the same for its ``model`` ranks.  A ``seq`` or ``expert`` axis of size
> 1 raises NotImplementedError.
"""
import contextlib
import itertools

import numpy as np
import torch

from ..distributed import spmd
from ..distributed.spmd import swapped_all
from ..optimizer.lr import LRScheduler
from .hybrid import (FlatLayout, _mean, _moved, amp_cast, clean_spec,
                     dense_grads, local_shape, make_fused_update,
                     refuse_eager_only_params, seeded_generator, shard_axes_of,
                     shard_of, zero_shard_update)


class PipeStagePlan:
    """A model's parameters split into its homogeneous blocks (names
    ``{prefix}{layer}.{relative name}``) and the rest."""

    def __init__(self, model, block_param_prefix):
        self.model = model
        self.prefix = block_param_prefix
        per_layer, other = {}, {}
        for n, p in model.named_parameters():
            if n.startswith(self.prefix):
                idx, rel = n[len(self.prefix):].split(".", 1)
                per_layer.setdefault(int(idx), {})[rel] = p
            else:
                other[n] = p
        self.num_layers = len(per_layer)
        if self.num_layers == 0:
            raise ValueError(f"no params under prefix {self.prefix!r}")
        self.rel_names = sorted(per_layer[0])
        for i in range(self.num_layers):
            if sorted(per_layer.get(i, {})) != self.rel_names:
                raise ValueError("pipeline blocks must be homogeneous")
        self.per_layer = per_layer
        self.other = other


class GPTPipeAdapter:
    """``GPTForPretraining``'s embedding, block and head as functions of
    the tensors that hold their parameters (swapped into the model's
    slots for the call): one rank's dict and tensors, or per-rank lists
    of them inside a group scope."""

    def __init__(self, model):
        self.model = model
        self.plan = PipeStagePlan(model, "gpt.blocks.")
        self.template_block = model.gpt.blocks[0]

    def _held(self, module, params, x):
        _, mods, _ = spmd.ranks_of(module, x)
        return swapped_all(mods, spmd.listed(params, 1))

    def embed(self, other_params, ids, generator=None):
        with self._held(self.model, other_params, ids):
            return self.model.gpt.embed(ids, generator)

    def block(self, rel_params, x, generator=None, remat=False):
        blk = self.template_block
        with self._held(blk, rel_params, x):
            if not remat:
                return blk(x, generator)
            _, mods, _ = spmd.ranks_of(blk, x)
            return spmd.checkpoint_ranks(mods, spmd.listed(generator, 1),
                                         lambda: blk(x, generator))

    def head_loss(self, other_params, h, labels):
        with self._held(self.model, other_params, h):
            return self.model.head_loss(h, labels)


class PipelinedTrainStep:
    """Build once, call ``step(ids, labels)`` per global batch.  `mesh`
    (a `Mesh`) must have a ``pipe`` axis dividing the model's layers;
    ``data`` and ``model`` axes compose."""

    def __init__(self, adapter, optimizer, mesh, num_micro, amp_dtype=None,
                 remat=True, zero_stage=1, seed=0):
        who = type(self).__name__
        optimizer.refuse_eager_only(who)
        self.adapter = adapter
        self.plan = plan = adapter.plan
        self.model = adapter.model
        self.optimizer = optimizer
        self.mesh = mesh
        self.num_micro = int(num_micro)
        self.amp_dtype = amp_dtype
        self.remat = bool(remat)
        if "pipe" not in mesh.axis_names:
            raise ValueError("mesh needs a 'pipe' axis")
        for ax in ("seq", "expert"):
            if mesh.axis_size(ax) > 1:
                raise NotImplementedError(
                    f"{who}: a {ax!r} axis of size {mesh.shape[ax]} is not "
                    f"ported to the pipeline (data and model compose)")
        params = dict(self.model.named_parameters())
        refuse_eager_only_params(params, who)
        self.S = mesh.shape["pipe"]
        if plan.num_layers % self.S:
            raise ValueError(f"{plan.num_layers} layers not divisible by "
                             f"pipe={self.S}")
        self.per_stage = plan.num_layers // self.S
        self.dp = mesh.axis_size("data")
        self.zero_stage = int(zero_stage) if self.dp > 1 else 0
        self.zero = self.zero_stage >= 1
        tmpl = plan.per_layer[0]
        self.other_specs = {n: clean_spec(getattr(p, "dist_spec", None),
                                          mesh, p.shape)
                            for n, p in plan.other.items()}
        self.block_specs = {rel: clean_spec(getattr(p, "dist_spec", None),
                                            mesh, p.shape)
                            for rel, p in tmpl.items()}
        used = shard_axes_of({**self.other_specs, **self.block_specs}, who)
        self.shard_axes = tuple(a for a in mesh.axis_names if a in used)
        self.combos = list(itertools.product(
            *(range(mesh.shape[a]) for a in self.shard_axes)))
        self.tp = mesh.axis_size("model")
        group_axes = {"model": self.tp} if self.tp > 1 else {}
        self.groups = [[spmd.RankGroup(group_axes, [
            mesh.device(**self._at(s, r, c)) for c in spmd.rank_coords(
                group_axes)]) for r in range(self.dp)]
            for s in range(self.S)]
        self.rank_combo = [self.combos.index(tuple(
            c.get(a, 0) for a in self.shard_axes))
            for c in spmd.rank_coords(group_axes)]
        self.replicas = spmd.replicas(self.model, len(self.rank_combo))
        self._model_device = next(iter(params.values())).device
        nz = self.dp if self.zero else 1
        align = int(np.lcm(self.dp, 1024)) if self.zero else 1024
        self.other_layout = FlatLayout(
            {n: local_shape(p.shape, self.other_specs[n], mesh)
             for n, p in plan.other.items()}, nz, align)
        self.block_layout = FlatLayout(
            {rel: (self.per_stage,) + local_shape(
                tmpl[rel].shape, self.block_specs[rel], mesh)
             for rel in plan.rel_names}, nz, align)
        self.generators = [[[seeded_generator(d, seed, mesh.index(
            **self._at(s, r, {}))) for d in self.groups[s][r].devices]
            for r in range(self.dp)] for s in range(self.S)]
        self.step_count = 0
        self.moved_bytes = 0
        with torch.no_grad():
            self.other = [{d: self._copy(plan.other, self.other_specs, c, d)
                           for d in self._devices(c, range(self.S))}
                          for c in range(len(self.combos))]
            self.blocks = [[{d: [self._copy(
                plan.per_layer[s * self.per_stage + j], self.block_specs, c,
                d) for j in range(self.per_stage)]
                for d in self._devices(c, [s])}
                for c in range(len(self.combos))] for s in range(self.S)]
            self.state_other, self.state_block = self._init_states()
        self._fused_update = make_fused_update(optimizer)

    def _at(self, s, r, coords):
        at = {"pipe": s, **{a: v for a, v in coords.items()
                            if a in self.mesh.shape}}
        if "data" in self.mesh.axis_names:
            at["data"] = r
        return at

    def _home(self, s, c, q):
        """The device of stage `s`, combo `c`, data rank `q`."""
        return self.mesh.device(**self._at(s, q, dict(zip(
            self.shard_axes, self.combos[c]))))

    def _devices(self, c, stages):
        return list(dict.fromkeys(
            self.groups[s][r].devices[g] for s in stages
            for r in range(self.dp) for g in range(len(self.rank_combo))
            if self.rank_combo[g] == c))

    def _copy(self, named, specs, c, d):
        """Combo `c`'s shards of `named` on `d`: the model's own where
        they are whole and on its device, leaf copies elsewhere."""
        if len(self.combos) == 1 and d == self._model_device:
            return dict(named)
        co = dict(zip(self.shard_axes, self.combos[c]))
        return {n: shard_of(p.detach(), specs[n], co, self.mesh.shape)
                .to(d).clone().requires_grad_(True)
                for n, p in named.items()}

    def _init_states(self):
        """The optimizer state per group, one list per combo (flat, combo
        major): under ZeRO one range per data rank (the block group's per
        stage too), else one whole buffer (per stage for the blocks), on
        the owning shard's device."""
        opt = self.optimizer
        nq = self.dp if self.zero else 1

        def state(layout, d):
            return opt.init_state(torch.zeros(layout.shard_len,
                                              dtype=torch.float32, device=d))

        return ([state(self.other_layout, self._home(0, c, q))
                 for c in range(len(self.combos)) for q in range(nq)],
                [[state(self.block_layout, self._home(s, c, q))
                  for c in range(len(self.combos)) for q in range(nq)]
                 for s in range(self.S)])

    # ---- flat groups ----
    def _stacked(self, layers):
        """``{rel: [per_stage, ...]}`` of one stage's layer dicts."""
        return {rel: torch.stack([layer[rel] for layer in layers])
                for rel in self.plan.rel_names}

    def _block_flat(self, layers):
        return self.block_layout.flatten(self._stacked(layers))

    def _write_blocks(self, s, c, flat):
        views = self.block_layout.views(flat)
        for d, layers in self.blocks[s][c].items():
            self.moved_bytes += _moved(flat, d)
            v = {rel: t.to(d) for rel, t in views.items()}
            for j, layer in enumerate(layers):
                for rel, p in layer.items():
                    p.copy_(v[rel][j])

    def _write_other(self, c, flat):
        for d, own in self.other[c].items():
            self.moved_bytes += _moved(flat, d)
            views = self.other_layout.views(flat.to(d))
            for n, p in own.items():
                p.copy_(views[n])

    # ---- the pipelined forward and backward of one data shard ----
    def _hand(self, x):
        dt = self.amp_dtype or torch.float32
        return [t.to(dt) for t in x] if isinstance(x, list) else x.to(dt)

    def _ranks(self, vals):
        """Per-rank values as the adapter takes them: a list in a group,
        the one value outside."""
        return vals if len(vals) > 1 else vals[0]

    def _stage(self, s, r):
        grp = self.groups[s][r]
        return (spmd.scope(grp, self.replicas) if grp.size > 1
                else contextlib.nullcontext())

    def _shard_loss(self, r, ids, labels):
        """Data shard `r`'s summed micro-losses over its ``model`` ranks
        (for the gradients) and its mean micro-loss at ``model`` 0, the
        micro-batches issued in the JAX tick order."""
        S, M, amp = self.S, self.num_micro, self.amp_dtype
        mb = ids.shape[0] // M
        inbox, total, first = {}, None, []
        for t in range(M + S - 1):
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue
                devs = self.groups[s][r].devices
                gens = self._ranks(self.generators[s][r])
                rows = slice(m * mb, (m + 1) * mb)
                other = self._ranks([amp_cast(self.other[c][d], amp)
                                     for c, d in zip(self.rank_combo, devs)])
                with self._stage(s, r):
                    if s == 0:
                        x = self._hand(self.adapter.embed(
                            other, self._ranks([ids[rows].to(d)
                                                for d in devs]), gens))
                    else:
                        x = inbox.pop((s, m))
                    for j in range(self.per_stage):
                        layer = self._ranks([amp_cast(
                            self.blocks[s][c][d][j], amp)
                            for c, d in zip(self.rank_combo, devs)])
                        y = self.adapter.block(layer, x, gens, self.remat)
                        x = [yi.to(xi.dtype) for yi, xi in zip(y, x)] \
                            if isinstance(y, list) else y.to(x.dtype)
                    if s == S - 1:
                        loss = spmd.listed(self.adapter.head_loss(
                            other, x, self._ranks([labels[rows].to(d)
                                                   for d in devs])), 1)
                        for li in loss:
                            li = li.float().to(devs[0])
                            total = li if total is None else total + li
                        first.append(loss[0].float())
                        continue
                nd = self.groups[s + 1][r].devices
                xs = spmd.listed(x, 1)
                self.moved_bytes += sum(_moved(xi, d)
                                        for xi, d in zip(xs, nd))
                inbox[(s + 1, m)] = self._ranks([xi.to(d)
                                                 for xi, d in zip(xs, nd)])
        return total / M, _mean(first) if M > 1 else first[0]

    def _shard_grads(self, r, ids, labels):
        """Shard `r`'s loss, and per combo the replicated group's
        gradient summed over its stages' devices (the psum over ``pipe``)
        and each stage's block gradients."""
        total, loss = self._shard_loss(r, ids, labels)
        gens = [g for s in range(self.S) for g in self.generators[s][r]]
        ends = [g.get_state() for g in gens]
        o_names, rels = self.other_layout.names, self.plan.rel_names
        o_keys = [(c, d) for c in range(len(self.combos))
                  for d in dict.fromkeys(
                      self.groups[s][r].devices[g] for s in range(self.S)
                      for g, cg in enumerate(self.rank_combo) if cg == c)]
        b_keys = [(s, c, self.groups[s][r].devices[g]) for s in range(self.S)
                  for g, c in enumerate(self.rank_combo)]
        b_keys = list(dict.fromkeys(b_keys))
        inputs = [self.other[c][d][n] for c, d in o_keys for n in o_names]
        inputs += [layer[rel] for s, c, d in b_keys
                   for layer in self.blocks[s][c][d] for rel in rels]
        grads = dense_grads(torch.autograd.grad(total, inputs,
                                                allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(inputs, grads)]
        if self.remat:
            for g, st in zip(gens, ends):
                g.set_state(st)
        k = len(o_names)
        g_other = {}
        for i, (c, d) in enumerate(o_keys):
            got = dict(zip(o_names, grads[i * k:(i + 1) * k]))
            home = self._home(0, c, 0)
            if c in g_other:
                self.moved_bytes += sum(_moved(g, home)
                                        for g in got.values())
                g_other[c] = {n: g_other[c][n] + g.to(home)
                              for n, g in got.items()}
            else:
                g_other[c] = got
        pos = k * len(o_keys)
        g_blocks = [[None] * len(self.combos) for _ in range(self.S)]
        for s, c, d in b_keys:
            stage = []
            for _ in range(self.per_stage):
                stage.append(dict(zip(rels, grads[pos:pos + len(rels)])))
                pos += len(rels)
            g_blocks[s][c] = stage
        return loss.detach(), g_other, g_blocks

    def _batches(self, ids, labels):
        ids, labels = (b if isinstance(b, torch.Tensor) else
                       torch.as_tensor(np.asarray(b)) for b in (ids, labels))
        if ids.shape[0] % self.num_micro:
            raise ValueError(f"batch {ids.shape[0]} not divisible by "
                             f"num_micro={self.num_micro}")
        if self.dp > 1 and ids.shape[0] % (self.num_micro * self.dp) == 0:
            return list(zip(ids.chunk(self.dp), labels.chunk(self.dp)))
        return [(ids, labels)] * self.dp

    # ---- the step ----
    def step(self, ids, labels):
        """One training step; returns the loss before the update (a 0-d
        float32 tensor on the first shard's device)."""
        self.moved_bytes = 0
        lr = self.optimizer.get_lr()
        S, dp, nc = self.S, self.dp, len(self.combos)
        lo, lb = self.other_layout, self.block_layout
        nq = dp if self.zero else 1
        sums_o = [[None] * nq for _ in range(nc)]
        sums_b = [[[None] * nq for _ in range(nc)] for _ in range(S)]

        def add(sums, i, r, g, d):
            self.moved_bytes += _moved(g, d)
            g = g.to(d)
            sums[i] = g if r == 0 else sums[i] + g

        losses = []
        for r, (ids_r, lbl_r) in enumerate(self._batches(ids, labels)):
            loss, g_other, g_blocks = self._shard_grads(r, ids_r, lbl_r)
            losses.append(loss)
            for c in range(nc):
                go = lo.flatten(g_other[c])
                gb = [self._block_flat(g_blocks[s][c]) for s in range(S)]
                for q in range(nq):
                    part = (lambda f, lay: f[lay.range(q)]) if self.zero \
                        else (lambda f, lay: f)
                    add(sums_o[c], q, r, part(go, lo), self._home(0, c, q))
                    for s in range(S):
                        add(sums_b[s][c], q, r, part(gb[s], lb),
                            self._home(s, c, q))
            del g_other, g_blocks
        with torch.no_grad():
            for c in range(nc):
                self._update(c, sums_o[c], [sums_b[s][c] for s in range(S)],
                             lr)
        if isinstance(self.optimizer.learning_rate, LRScheduler):
            self.optimizer.learning_rate.step()
        self.step_count += 1
        first = self.groups[S - 1][0].devices[0]
        return _mean([x.to(first) for x in losses])

    def _update(self, c, sums_o, sums_b, lr):
        lo, lb, fu = self.other_layout, self.block_layout, self._fused_update
        dp = self.dp
        nq = dp if self.zero else 1
        so = self.state_other
        i0 = c * nq
        if self.zero:
            new = []
            for q in range(dp):
                d = self._home(0, c, q)
                own = self.other[c].get(d) or next(iter(
                    self.other[c].values()))
                pflat = lo.flatten({n: p.detach() for n, p in own.items()})
                p_new, so[i0 + q] = zero_shard_update(
                    sums_o[q], dp, pflat[lo.range(q)].to(d), so[i0 + q], lr,
                    fu)
                new.append(p_new)
            d0 = self._home(0, c, 0)
            self._write_other(c, torch.cat([x.to(d0) for x in new]))
            for s in range(self.S):
                sb = self.state_block[s]
                new = []
                for q in range(dp):
                    d = self._home(s, c, q)
                    layers = self.blocks[s][c].get(d) or next(iter(
                        self.blocks[s][c].values()))
                    pflat = self._block_flat([{rel: p.detach()
                                               for rel, p in layer.items()}
                                              for layer in layers])
                    p_new, sb[i0 + q] = zero_shard_update(
                        sums_b[s][q], dp, pflat[lb.range(q)].to(d),
                        sb[i0 + q], lr, fu)
                    new.append(p_new)
                ds = self._home(s, c, 0)
                self._write_blocks(s, c, torch.cat([x.to(ds) for x in new]))
            return
        d0 = self._home(0, c, 0)
        own = self.other[c].get(d0) or next(iter(self.other[c].values()))
        pflat = lo.flatten({n: p.detach() for n, p in own.items()}).to(d0)
        g = sums_o[0] / dp if dp > 1 else sums_o[0]
        p_new, so[i0] = fu(pflat, g, so[i0], lr)
        self._write_other(c, p_new)
        for s in range(self.S):
            ds = self._home(s, c, 0)
            layers = self.blocks[s][c].get(ds) or next(iter(
                self.blocks[s][c].values()))
            pflat = self._block_flat([{rel: p.detach()
                                       for rel, p in layer.items()}
                                      for layer in layers]).to(ds)
            g = sums_b[s][0] / dp if dp > 1 else sums_b[s][0]
            p_new, self.state_block[s][i0] = fu(
                pflat, g, self.state_block[s][i0], lr)
            self._write_blocks(s, c, p_new)

    def sync_to_model(self):
        """The model's parameters hold the step's current values, each
        rebuilt from its combos' shards (each stage's blocks from its
        first data shard's devices)."""
        plan, sizes = self.plan, self.mesh.shape
        with torch.no_grad():
            for c, co in enumerate(self.combos):
                at = dict(zip(self.shard_axes, co))
                own = next(iter(self.other[c].values()))
                for n, v in own.items():
                    dst = shard_of(plan.other[n], self.other_specs[n], at,
                                   sizes)
                    if dst.data_ptr() != v.data_ptr() or dst.shape != \
                            v.shape:
                        dst.copy_(v.to(dst.device))
                for s in range(self.S):
                    layers = next(iter(self.blocks[s][c].values()))
                    for j, layer in enumerate(layers):
                        mine = plan.per_layer[s * self.per_stage + j]
                        for rel, v in layer.items():
                            dst = shard_of(mine[rel], self.block_specs[rel],
                                           at, sizes)
                            if dst.data_ptr() != v.data_ptr() or \
                                    dst.shape != v.shape:
                                dst.copy_(v.to(dst.device))

    def state_dict(self):
        self.sync_to_model()
        return self.model.state_dict()


__all__ = ["GPTPipeAdapter", "PipeStagePlan", "PipelinedTrainStep"]
