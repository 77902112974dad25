"""Pipeline-parallel training over a ``pipe`` mesh axis, composed with
``data`` (``paddle_tpu/parallel/pipeline_compile.py``).

The model's homogeneous blocks (``gpt.blocks.*``) split over ``pipe``:
stage ``s`` of ``S`` holds blocks ``[s L/S, (s+1) L/S)`` on its device;
everything else (the embeddings, ``ln_f``, the tied head) is replicated
on every stage.  The global batch splits over ``data`` (when ``M dp``
divides it, else each data shard takes all of it) and each shard's rows
into `num_micro` micro-batches.  One process drives every shard: for
each data shard, the micro-batches are issued in the JAX tick order
(``M + S - 1`` ticks, stage ``s`` taking micro-batch ``t - s`` at tick
``t``), so across cards each stage's launches queue on its own card
while the next micro-batch enters; stage 0 embeds, the last stage
computes ``head_loss``, and the activation handed on is cast to
``amp_dtype or float32``, after every block as at every hand-off (the
JAX scan's carry: under AMP the residual stream is rounded to bf16).
The loss is the mean of the micro-losses (their sum over M), meaned
over ``data``.  The replicated parameters' gradients are summed over
``pipe``, which gives the tied embedding both its contributions.

The update is flat per group and stage, as in JAX: the replicated
parameters (``other``, in sorted name order) and each stage's blocks
(``block``: for each sorted relative name, the stage's layers stacked
in order), padded with zeros to ``lcm(dp, 1024)`` under ZeRO and to 1024
without.  With a live ``data`` axis and ``zero_stage >= 1`` the
optimizer state of each group range-shards over ``data`` through
``hybrid.zero_shard_update``; otherwise the gradients are meaned over
``data`` and each group updates whole.  ``remat=True`` (the default)
checkpoints each block, its recompute drawing the forward's dropout
masks.  Dropout draws from a ``torch.Generator`` per (stage, data) shard.
A ``model``, ``seq`` or ``expert`` axis of size > 1 raises
NotImplementedError.
"""
import numpy as np
import torch

from ..optimizer.lr import LRScheduler
from .hybrid import (FlatLayout, _mean, _moved, amp_cast, checkpoint_block,
                     make_fused_update, refuse_eager_only_params,
                     refuse_unported_axes, shard_generators, swapped,
                     zero_shard_update)


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
    slots for the call)."""

    def __init__(self, model):
        self.model = model
        self.plan = PipeStagePlan(model, "gpt.blocks.")
        self.template_block = model.gpt.blocks[0]

    def embed(self, other_params, ids, generator=None):
        with swapped(self.model, other_params):
            return self.model.gpt.embed(ids, generator)

    def block(self, rel_params, x, generator=None, remat=False):
        if remat:
            return checkpoint_block(self.template_block, rel_params,
                                    generator, x, generator)
        with swapped(self.template_block, rel_params):
            return self.template_block(x, generator)

    def head_loss(self, other_params, h, labels):
        with swapped(self.model, other_params):
            return self.model.head_loss(h, labels)


class PipelinedTrainStep:
    """Build once, call ``step(ids, labels)`` per global batch.  `mesh`
    (a `Mesh`) must have a ``pipe`` axis dividing the model's layers; a
    ``data`` axis composes."""

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
        params = dict(self.model.named_parameters())
        refuse_eager_only_params(params, who)
        refuse_unported_axes(mesh, params, who)
        self.S = mesh.shape["pipe"]
        if plan.num_layers % self.S:
            raise ValueError(f"{plan.num_layers} layers not divisible by "
                             f"pipe={self.S}")
        self.per_stage = plan.num_layers // self.S
        self.dp = mesh.axis_size("data")
        self.zero_stage = int(zero_stage) if self.dp > 1 else 0
        self.zero = self.zero_stage >= 1
        self.devs = [[mesh.devices[self._flat(s, r)] for r in range(self.dp)]
                     for s in range(self.S)]
        self._model_device = next(iter(params.values())).device
        shard_dp = self.dp if self.zero else 1
        align = int(np.lcm(self.dp, 1024)) if self.zero else 1024
        self.other_layout = FlatLayout(
            {n: p.shape for n, p in plan.other.items()}, shard_dp, align)
        tmpl = plan.per_layer[0]
        self.block_layout = FlatLayout(
            {rel: (self.per_stage,) + tuple(tmpl[rel].shape)
             for rel in plan.rel_names}, shard_dp, align)
        gens = shard_generators(list(mesh.devices), seed)
        self.generators = [[gens[self._flat(s, r)] for r in range(self.dp)]
                           for s in range(self.S)]
        self.step_count = 0
        self.moved_bytes = 0
        with torch.no_grad():
            devices = dict.fromkeys(d for row in self.devs for d in row)
            self.other = {d: self._copy(plan.other, d) for d in devices}
            self.blocks = [{d: [self._copy(plan.per_layer[s * self.per_stage
                                                          + j], d)
                                for j in range(self.per_stage)]
                            for d in dict.fromkeys(self.devs[s])}
                           for s in range(self.S)]
            self.state_other, self.state_block = self._init_states()
        self._fused_update = make_fused_update(optimizer)

    def _flat(self, s, r):
        coords = {"pipe": s}
        if "data" in self.mesh.axis_names:
            coords["data"] = r
        return self.mesh.index(**coords)

    def _copy(self, named, d):
        """`named`'s tensors on `d`: the model's own there, leaf copies
        elsewhere."""
        if d == self._model_device:
            return dict(named)
        return {n: p.detach().to(d).requires_grad_(True)
                for n, p in named.items()}

    def _init_states(self):
        """The optimizer state per group: under ZeRO one range per data
        rank (the block group's per stage too), else one whole buffer
        (per stage for the blocks), on the owning shard's device."""
        opt = self.optimizer

        def state(layout, d):
            return opt.init_state(torch.zeros(layout.shard_len,
                                              dtype=torch.float32, device=d))

        if self.zero:
            return ([state(self.other_layout, self.devs[0][r])
                     for r in range(self.dp)],
                    [[state(self.block_layout, self.devs[s][r])
                      for r in range(self.dp)] for s in range(self.S)])
        return ([state(self.other_layout, self.devs[0][0])],
                [[state(self.block_layout, self.devs[s][0])]
                 for s in range(self.S)])

    # ---- flat groups ----
    def _stacked(self, layers):
        """``{rel: [per_stage, ...]}`` of one stage's layer dicts."""
        return {rel: torch.stack([layer[rel] for layer in layers])
                for rel in self.plan.rel_names}

    def _block_flat(self, layers):
        return self.block_layout.flatten(self._stacked(layers))

    def _write_blocks(self, s, flat):
        views = self.block_layout.views(flat)
        for d, layers in self.blocks[s].items():
            self.moved_bytes += _moved(flat, d)
            v = {rel: t.to(d) for rel, t in views.items()}
            for j, layer in enumerate(layers):
                for rel, p in layer.items():
                    p.copy_(v[rel][j])

    def _write_other(self, flat):
        for d, own in self.other.items():
            self.moved_bytes += _moved(flat, d)
            views = self.other_layout.views(flat.to(d))
            for n, p in own.items():
                p.copy_(views[n])

    # ---- the pipelined forward and backward of one data shard ----
    def _hand(self, x):
        return x.to(self.amp_dtype or torch.float32)

    def _shard_loss(self, r, ids, labels):
        """Data shard `r`'s mean micro-loss, its micro-batches issued in
        the JAX tick order."""
        S, M, amp = self.S, self.num_micro, self.amp_dtype
        mb = ids.shape[0] // M
        inbox, losses = {}, []
        for t in range(M + S - 1):
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue
                d, gen = self.devs[s][r], self.generators[s][r]
                rows = slice(m * mb, (m + 1) * mb)
                if s == 0:
                    x = self._hand(self.adapter.embed(
                        amp_cast(self.other[d], amp), ids[rows].to(d), gen))
                else:
                    x = inbox.pop((s, m))
                for layer in self.blocks[s][d]:
                    x = self.adapter.block(amp_cast(layer, amp), x, gen,
                                           self.remat).to(x.dtype)
                if s == S - 1:
                    losses.append(self.adapter.head_loss(
                        amp_cast(self.other[d], amp), x,
                        labels[rows].to(d)).float())
                else:
                    nd = self.devs[s + 1][r]
                    self.moved_bytes += _moved(x, nd)
                    inbox[(s + 1, m)] = x.to(nd)
        total = losses[0]
        for x in losses[1:]:
            total = total + x
        return total / M

    def _shard_grads(self, r, ids, labels):
        """Shard `r`'s loss, the replicated group's gradient summed over
        its stages' devices (the psum over ``pipe``), and each stage's
        block gradients."""
        loss = self._shard_loss(r, ids, labels)
        ends = [self.generators[s][r].get_state() for s in range(self.S)]
        o_devs = list(dict.fromkeys(self.devs[s][r] for s in range(self.S)))
        o_names = self.other_layout.names
        inputs = [self.other[d][n] for d in o_devs for n in o_names]
        blocks = [self.blocks[s][self.devs[s][r]] for s in range(self.S)]
        for layers in blocks:
            inputs += [layer[rel] for layer in layers
                       for rel in self.plan.rel_names]
        grads = list(torch.autograd.grad(loss, inputs, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(inputs, grads)]
        if self.remat:
            for s in range(self.S):
                self.generators[s][r].set_state(ends[s])
        k = len(o_names)
        g_other = dict(zip(o_names, grads[:k]))
        for i in range(1, len(o_devs)):
            self.moved_bytes += sum(_moved(g, o_devs[0])
                                    for g in grads[i * k:(i + 1) * k])
            g_other = {n: g_other[n] + g.to(o_devs[0])
                       for n, g in zip(o_names, grads[i * k:(i + 1) * k])}
        pos = k * len(o_devs)
        g_blocks = []
        for layers in blocks:
            stage = []
            for _ in layers:
                n = len(self.plan.rel_names)
                stage.append(dict(zip(self.plan.rel_names,
                                      grads[pos:pos + n])))
                pos += n
            g_blocks.append(stage)
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
        S, dp = self.S, self.dp
        lo, lb = self.other_layout, self.block_layout
        sums_o = [None] * (dp if self.zero else 1)
        sums_b = [[None] * len(sums_o) for _ in range(S)]

        def add(sums, i, r, g, d):
            self.moved_bytes += _moved(g, d)
            g = g.to(d)
            sums[i] = g if r == 0 else sums[i] + g

        losses = []
        for r, (ids_r, lbl_r) in enumerate(self._batches(ids, labels)):
            loss, g_other, g_blocks = self._shard_grads(r, ids_r, lbl_r)
            losses.append(loss)
            go = lo.flatten(g_other)
            gb = [self._block_flat(stage) for stage in g_blocks]
            if self.zero:
                for q in range(dp):
                    add(sums_o, q, r, go[lo.range(q)], self.devs[0][q])
                    for s in range(S):
                        add(sums_b[s], q, r, gb[s][lb.range(q)],
                            self.devs[s][q])
            else:
                add(sums_o, 0, r, go, self.devs[0][0])
                for s in range(S):
                    add(sums_b[s], 0, r, gb[s], self.devs[s][0])
            del g_other, g_blocks, go, gb
        with torch.no_grad():
            self._update(sums_o, sums_b, lr)
        if isinstance(self.optimizer.learning_rate, LRScheduler):
            self.optimizer.learning_rate.step()
        self.step_count += 1
        first = self.devs[S - 1][0]
        return _mean([x.to(first) for x in losses])

    def _update(self, sums_o, sums_b, lr):
        lo, lb, fu = self.other_layout, self.block_layout, self._fused_update
        dp = self.dp
        if self.zero:
            new = []
            for q in range(dp):
                d = self.devs[0][q]
                pflat = lo.flatten({n: p.detach()
                                    for n, p in self.other[d].items()})
                p_new, self.state_other[q] = zero_shard_update(
                    sums_o[q], dp, pflat[lo.range(q)], self.state_other[q],
                    lr, fu)
                new.append(p_new)
            d0 = self.devs[0][0]
            self._write_other(torch.cat([x.to(d0) for x in new]))
            for s in range(self.S):
                new = []
                for q in range(dp):
                    d = self.devs[s][q]
                    pflat = self._block_flat([{rel: p.detach()
                                               for rel, p in layer.items()}
                                              for layer in self.blocks[s][d]])
                    p_new, self.state_block[s][q] = zero_shard_update(
                        sums_b[s][q], dp, pflat[lb.range(q)],
                        self.state_block[s][q], lr, fu)
                    new.append(p_new)
                ds = self.devs[s][0]
                self._write_blocks(s, torch.cat([x.to(ds) for x in new]))
            return
        d0 = self.devs[0][0]
        pflat = lo.flatten({n: p.detach() for n, p in self.other[d0].items()})
        g = sums_o[0] / dp if dp > 1 else sums_o[0]
        p_new, self.state_other[0] = fu(pflat, g, self.state_other[0], lr)
        self._write_other(p_new)
        for s in range(self.S):
            ds = self.devs[s][0]
            pflat = self._block_flat([{rel: p.detach()
                                       for rel, p in layer.items()}
                                      for layer in self.blocks[s][ds]])
            g = sums_b[s][0] / dp if dp > 1 else sums_b[s][0]
            p_new, self.state_block[s][0] = fu(pflat, g,
                                               self.state_block[s][0], lr)
            self._write_blocks(s, p_new)

    def sync_to_model(self):
        """The model's parameters hold the step's current values (each
        stage's blocks from its first data shard's device)."""
        plan = self.plan
        with torch.no_grad():
            for n, v in self.other[self.devs[0][0]].items():
                if plan.other[n] is not v:
                    plan.other[n].copy_(v.to(plan.other[n].device))
            for s in range(self.S):
                for j, layer in enumerate(self.blocks[s][self.devs[s][0]]):
                    own = plan.per_layer[s * self.per_stage + j]
                    for rel, v in layer.items():
                        if own[rel] is not v:
                            own[rel].copy_(v.to(own[rel].device))

    def state_dict(self):
        self.sync_to_model()
        return self.model.state_dict()


__all__ = ["GPTPipeAdapter", "PipeStagePlan", "PipelinedTrainStep"]
