"""The static executor (``paddle_tpu/static/executor.py``): runs a block's
ops in program order on one device.

Parameters, optimizer state and running stats live in a `Scope` (name ->
tensor).  `Executor.run` builds a `CompiledBlock` per (program, feed
names and shapes, fetch names, AMP flag) and runs it: feeds and
persistables in, fetches out, updated persistables written back to the
scope.  The block's ops are already in topological order, so the
order is the program's (the JAX package's planner fallback); on top of
it a liveness pass drops each value after its last reader, and a grad
op computes only the input gradients that something reads or fetches
(see ``backward.py`` for how a grad op differentiates its forward op's
saved graph).  Update ops, and every op without a grad op, run under
``torch.no_grad()``.

Static AMP (``program._amp_bf16``, set by ``amp.decorate`` at minimize)
casts at the use site: an op in `_AMP_BF16_OPS` gets every float32
operand of rank >= 2 as bfloat16 (1-D floats stay float32: batch-norm
scale, bias and stats, biases); an op in `_AMP_F32_OPS` gets bfloat16
operands as float32.  Parameters stay float32 in the scope.

A sub-block (control flow, a StaticRNN step) runs inside its parent
op's fn (``controlflow.py``).  An inference clone
(``Program.clone(for_test=True)``) holds no grad or update op, so it
runs the forward alone.

Not ported, each raising NotImplementedError: a program with
``_mesh_axes`` (GSPMD), a multi-stage ``_pipeline_opt``,
``FLAGS_check_nan_inf`` (read from the environment, as the JAX package
reads its flags), static AMP over a program with sub-blocks (their ops
would run uncast), ``train_from_dataset`` and ``infer_from_dataset``.
"""
import os

import numpy as np
import torch

from ..device import resolve_device
from .backward import forward_saving
from .program import Variable, default_main_program


class Scope:
    """name -> value store (flat)."""

    def __init__(self):
        self._vars = {}

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def get(self, name):
        return self._vars.get(name)

    def names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


def coerce_feeds(feed_names, feed, device):
    """The feed dict as tensors on `device`: numpy arrays (or anything
    numpy takes) are copied there, a tensor already there is used as it
    is."""
    feeds = {}
    for n in feed_names:
        if n not in feed:
            raise KeyError(
                f"feed variable {n!r} missing from feed dict "
                f"(declared feeds: {list(feed_names)})")
        v = feed[n]
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        feeds[n] = v if v.device == device else v.to(device)
    return feeds


_AMP_BF16_OPS = frozenset({
    "conv2d", "conv2d_grad", "conv2d_bias", "conv2d_bias_grad",
    "conv3d", "conv3d_grad", "fc", "fc_grad", "matmul", "matmul_grad",
    "mul", "mul_grad", "pool2d", "pool2d_grad", "relu", "relu_grad",
    "elementwise_add", "elementwise_add_grad", "flatten", "flatten_grad",
    "sum", "batch_norm", "batch_norm_grad", "dropout", "dropout_grad",
})
_AMP_F32_OPS = frozenset({
    "softmax", "softmax_grad", "softmax_with_cross_entropy",
    "softmax_with_cross_entropy_grad", "cross_entropy", "cross_entropy_grad",
    "reduce_mean", "reduce_mean_grad", "reduce_sum", "reduce_sum_grad",
    "mean", "mean_grad", "fill_constant_grad",
    "momentum", "sgd", "adam", "adamw", "lars_momentum", "rmsprop",
})


def _amp_cast_args(op_type, args):
    if op_type in _AMP_BF16_OPS:
        return [a.to(torch.bfloat16)
                if (isinstance(a, torch.Tensor) and a.dtype == torch.float32
                    and a.dim() >= 2) else a
                for a in args]
    if op_type in _AMP_F32_OPS:
        return [a.float()
                if (isinstance(a, torch.Tensor)
                    and a.dtype == torch.bfloat16) else a
                for a in args]
    return args


# how the block runs an op
_PLAIN, _SAVE, _GRAD, _SOURCE = range(4)


class CompiledBlock:
    """One block planned for given feeds and fetches: `run`,
    `run_chained` and `cost_analysis` over a scope."""

    def __init__(self, program, feed_names, fetch_names, scope, device):
        self.device = device
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        block = program.global_block()
        self.param_names = [
            n for n, v in block.vars.items()
            if v.persistable and scope.get(n) is not None
        ]
        self._amp_bf16 = bool(getattr(program, "_amp_bf16", False))
        self._rng_steps = list(getattr(program, "_rng_step_vars", ()))
        self._steps = self._plan(block)

    def _plan(self, block):
        """Each op with a fn as (kind, op type, fn, input names, output
        names, extra, names to drop after it); extra is the forward op's
        index for a grad op, and (that index, the inputs to
        differentiate) for a forward op whose graph is saved."""
        ops = block.ops
        grad_ops = {}
        for op in ops:
            fwd = getattr(op, "forward_op", None)
            if fwd is not None:
                if fwd in grad_ops:
                    raise NotImplementedError(
                        f"op {fwd} ({ops[fwd].type}) has two grad ops: "
                        "append_backward ran twice over one program")
                grad_ops[fwd] = op
        keep = set(self.fetch_names) | set(self.param_names)
        plan = []
        for idx, op in enumerate(ops):
            if op.fn is None:
                continue  # structural ops (feed/fetch/init markers)
            outs = list(getattr(op, "out_order", op.output_names()))
            extra = None
            if getattr(op, "forward_op", None) is not None:
                kind, ins, extra = _GRAD, op.input("Out@GRAD"), op.forward_op
            else:
                ins = list(getattr(op, "in_order", op.input_names()))
                kind = _SOURCE if not ins else _PLAIN
                if idx in grad_ops:
                    kind, extra = _SAVE, grad_ops[idx]
            plan.append([kind, op.type, op.fn, ins, outs, extra])
        read = {n for step in plan for n in step[3]}
        for step in plan:
            if step[0] == _SAVE:
                gop = step[5]
                # differentiate only inputs whose gradient is read or kept
                step[5] = (gop.forward_op,
                           [i if g in read or g in keep else None
                            for i, g in zip(gop.diff_idx, gop.out_order)])
        last = {}
        for i, step in enumerate(plan):
            for n in step[3] + step[4]:
                last[n] = i
        free = [[] for _ in plan]
        for n, i in last.items():
            if n not in keep:
                free[i].append(n)
        return [tuple(step) + (tuple(f),) for step, f in zip(plan, free)]

    def _run_block(self, feeds, params):
        env = dict(params)
        env.update(feeds)
        saved = {}
        amp = self._amp_bf16
        with torch.no_grad():
            for kind, op_type, fn, ins, outs, extra, free in self._steps:
                args = [env[n] for n in ins]
                if amp:
                    args = _amp_cast_args(op_type, args)
                if kind == _PLAIN:
                    res = fn(*args)
                elif kind == _SAVE:
                    res, saved[extra[0]] = forward_saving(fn, args, extra[1])
                elif kind == _GRAD:
                    res = fn(saved.pop(extra), *args)
                else:
                    res = fn(device=self.device)
                if not isinstance(res, tuple):
                    res = (res,)
                for n, v in zip(outs, res):
                    if v is not None:
                        env[n] = v
                for n in free:
                    env.pop(n, None)
        return ([env[n] for n in self.fetch_names],
                {n: env[n] for n in self.param_names if n in env})

    def _inputs(self, feed, scope):
        return (coerce_feeds(self.feed_names, feed, self.device),
                {n: scope.get(n) for n in self.param_names})

    def _run_checked(self, feeds, params):
        try:
            return self._run_block(feeds, params)
        except KeyError as e:
            raise KeyError(
                f"variable {e.args[0]!r} is needed by the fetch targets "
                "but was neither fed nor produced by any op") from e

    def run(self, feed, scope):
        """One step; the fetches as tensors on the device."""
        outs, updated = self._run_checked(*self._inputs(feed, scope))
        for n, v in updated.items():
            scope.set(n, v)
        return outs

    def run_chained(self, feed, scope, n_steps):
        """`n_steps` dependent steps with no host sync between them (the
        counterpart of the JAX package's ``lax.scan`` over the block,
        every persistable carried); the RNG step counters advance per
        step.  Each fetch comes back stacked over the steps, on the
        device."""
        feeds, params = self._inputs(feed, scope)
        per_step = []
        for _ in range(n_steps):
            outs, params = self._run_checked(feeds, params)
            for n in self._rng_steps:
                if n in params:
                    params[n] = params[n] + 1
            per_step.append(outs)
        for n, v in params.items():
            scope.set(n, v)
        return [torch.stack([outs[i] for outs in per_step])
                for i in range(len(self.fetch_names))]

    def cost_analysis(self, feed, scope):
        """``{"flops": n}``: the floating-point operations of one run of
        the block (forward, backward and updates) as
        ``torch.utils.flop_counter.FlopCounterMode`` counts them, the
        scope left as it was; None where this PyTorch has no flop
        counter."""
        try:
            from torch.utils.flop_counter import FlopCounterMode
        except ImportError:
            return None
        feeds, params = self._inputs(feed, scope)
        with FlopCounterMode(display=False) as counter:
            self._run_checked(feeds, params)
        return {"flops": counter.get_total_flops()}


def replay_ops(program, env, device):
    """Each op of `program`'s block once, in order, on the values `env`
    holds for its inputs when it is reached (copied to `device`, cast as
    static AMP casts them; a grad op differentiates the graph its forward
    op saved from those values).  Yields ``(index, op, outputs)`` after
    each op, the outputs in ``op.out_order``; the caller sets env's value
    of each output before the next, so that every op can be held against
    a reference run on that run's own values of its inputs."""
    device = torch.device(device)
    amp = bool(getattr(program, "_amp_bf16", False))
    ops = program.global_block().ops
    grad_ops = {op.forward_op: op for op in ops
                if getattr(op, "forward_op", None) is not None}
    saved = {}
    for idx, op in enumerate(ops):
        if op.fn is None:
            continue
        grad = getattr(op, "forward_op", None) is not None
        args = [env[n].to(device) for n in (op.input("Out@GRAD") if grad
                                            else op.in_order)]
        if amp:
            args = _amp_cast_args(op.type, args)
        if grad:
            res = op.fn(saved.pop(op.forward_op), *args)
        elif not op.in_order:
            res = op.fn(device=device)
        elif idx in grad_ops:
            res, saved[idx] = forward_saving(op.fn, args,
                                             grad_ops[idx].diff_idx)
        else:
            with torch.no_grad():
                res = op.fn(*args)
        yield idx, op, res if isinstance(res, tuple) else (res,)


def _to_numpy(t):
    """A fetched tensor as a numpy array; numpy has no bfloat16, so a
    bfloat16 fetch comes back as float32 (exactly its values)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _refuse_unported(program):
    """NotImplementedError for what the port does not run yet — never a
    silent switch to another path."""
    unported = []
    if getattr(program, "_mesh_axes", None):
        unported.append("a program with _mesh_axes (GSPMD)")
    popt = getattr(program, "_pipeline_opt", None)
    if popt and int(popt.get("num_stages", 1)) > 1:
        unported.append("a multi-stage _pipeline_opt")
    if os.environ.get("FLAGS_check_nan_inf", "").lower() in ("1", "true",
                                                             "yes"):
        unported.append("FLAGS_check_nan_inf")
    if getattr(program, "_amp_bf16", False) and len(program.blocks) > 1:
        # the ops a sub-block runs would go uncast: never silently
        unported.append("static AMP over a program with sub-blocks "
                        "(control flow, StaticRNN)")
    if unported:
        raise NotImplementedError(
            "not supported by the PyTorch port yet: " + ", ".join(unported)
            + " (it runs one program's block on one device)")


class Executor:
    """Runs programs on `place`: None means the card, and a missing card
    raises (`device.resolve_device`) instead of running on the CPU."""

    def __init__(self, place=None):
        self.place = resolve_device(place, "Executor")
        self._cache = {}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        """One step of `program` (or the startup program's init ops);
        the fetches as numpy arrays, or as tensors on the device with
        ``return_numpy=False``."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or _global_scope

        if _is_startup(program):
            self._run_startup(program, scope)
            return []

        cb = self._get_block(program, feed, fetch_list, scope)
        outs = cb.run(feed, scope)
        # RNG step counters advance once per run, outside the block
        for n in getattr(program, "_rng_step_vars", ()):
            v = scope.get(n)
            if v is not None:
                scope.set(n, v + 1)
        return [_to_numpy(o) for o in outs] if return_numpy else outs

    def run_chained(self, program=None, feed=None, fetch_list=None,
                    n_steps=1, scope=None, return_numpy=True):
        """`n_steps` dependent steps of `program` with no host sync between
        them (see `CompiledBlock.run_chained`).  Fetches come back with a
        leading n_steps axis (e.g. the loss curve of the chain), copied
        to the host once, at the end."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or _global_scope
        cb = self._get_block(program, feed, fetch_list, scope)
        outs = cb.run_chained(feed, scope, int(n_steps))
        return [_to_numpy(o) for o in outs] if return_numpy else outs

    @staticmethod
    def _feed_shape(v):
        s = getattr(v, "shape", None)
        return tuple(s) if s is not None else np.asarray(v).shape

    def _cache_key(self, program, feed, fetch_names):
        feed_names = tuple(sorted(feed.keys()))
        shapes = tuple(self._feed_shape(v) for _, v in sorted(feed.items()))
        # _version: program-rewriting passes bump it so stale blocks miss
        return (id(program), getattr(program, "_version", 0), feed_names,
                tuple(fetch_names), shapes,
                bool(getattr(program, "_amp_bf16", False)))

    def _get_block(self, program, feed, fetch_list, scope):
        _refuse_unported(program)
        fetch_names = [
            f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or [])
        ]
        key = self._cache_key(program, feed, fetch_names)
        cb = self._cache.get(key)
        if cb is None:
            cb = CompiledBlock(program, feed.keys(), fetch_names, scope,
                               self.place)
            self._cache[key] = cb
        return cb

    def cost_analysis(self, program=None, feed=None, fetch_list=None,
                      scope=None):
        """The cost of the block `run` would execute for these args (see
        `CompiledBlock.cost_analysis`)."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or _global_scope
        cb = self._get_block(program, feed, fetch_list, scope)
        return cb.cost_analysis(feed, scope)

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.train_from_dataset is not ported yet")

    def infer_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.infer_from_dataset is not ported yet")

    def _run_startup(self, program, scope):
        """The init ops, in order, on one generator of this executor's
        device seeded from ``program.random_seed``; a var the scope
        already holds is left as it is."""
        generator = torch.Generator(device=self.place)
        generator.manual_seed(int(program.random_seed))
        for op in program.global_block().ops:
            if op.type == "init" and op.fn is not None:
                out_name = op.outputs["Out"][0]
                if scope.get(out_name) is None:
                    scope.set(out_name, op.fn(generator, self.place))

    def close(self):
        pass


def _is_startup(program):
    ops = program.global_block().ops
    return bool(ops) and all(
        op.type in ("init", "c_comm_init", "c_gen_nccl_id",
                    "listen_and_serv")
        for op in ops)
