"""Static autodiff: append_backward (``paddle_tpu/static/backward.py``).

Forward ops are walked in reverse and each one that needs it gets one
``<type>_grad`` op; a gradient with several consumers is accumulated
through ``NAME@GRAD@RENAME@k`` and ``sum`` ops into ``NAME@GRAD@SUM@k``,
and each parameter's gradient ends in ``NAME@GRAD`` (an ``assign``
where it had to be renamed).  Every name and op type is the JAX
package's, but for an op that reads one var in two slots (``x * x``):
the JAX package names both of its gradients ``x@GRAD``, so the second
overwrites the first and x gets half its gradient; here the second slot
accumulates like another consumer.

The grad op does not recompute its forward op (eager PyTorch has no
common-subexpression pass to remove a recomputation).  The executor
runs a forward op that has a grad op through `forward_saving`, on
detached, ``requires_grad`` copies of its differentiable inputs, and
keeps that op-local graph; the grad op (``fn(saved, *out_grads)``, its
``forward_op`` the forward op's index) casts each cotangent to its
forward output's dtype and differentiates the saved graph
(`grad_from_saved`).  A missing cotangent counts as zero, as in the JAX
package.  A bool or integer var (a comparison's output) carries no
gradient.  An op with a ``grad_error`` (a ``while`` op: ``jax.vjp`` of
``lax.while_loop`` raises) gets a grad op that raises that ValueError
when it runs, where the JAX executor raises.
"""
import torch

from .program import Variable

GRAD_SUFFIX = "@GRAD"


def _grad_name(name):
    return name + GRAD_SUFFIX


def forward_saving(fn, args, diff_idx):
    """Run ``fn(*args)`` recording an op-local graph from the inputs at
    `diff_idx` (those that are None are not differentiated).  Returns the
    detached outputs (a tuple) and the saved graph."""
    args = list(args)
    prims = []
    for i in diff_idx:
        if i is None:
            prims.append(None)
            continue
        args[i] = args[i].detach().requires_grad_()
        prims.append(args[i])
    with torch.enable_grad():
        outs = fn(*args)
    if not isinstance(outs, tuple):
        outs = (outs,)
    return tuple(o.detach() for o in outs), (prims, outs)


def grad_from_saved(saved, avail_mask, out_grads):
    """The gradients of a saved op-local graph's inputs (None where not
    differentiated; zeros where no output reaches them) for the
    cotangents `out_grads` of the outputs marked in `avail_mask`."""
    prims, outs = saved
    out_grads = iter(out_grads)
    targets, cots = [], []
    for o, avail in zip(outs, avail_mask):
        if not avail:
            continue
        g = next(out_grads)
        if o.requires_grad:
            targets.append(o)
            cots.append(g if g.dtype == o.dtype else g.to(o.dtype))
    live = [p for p in prims if p is not None]
    grads = iter(torch.autograd.grad(targets, live, cots, allow_unused=True)
                 if targets and live else [None] * len(live))
    res = []
    for p in prims:
        g = None if p is None else next(grads)
        res.append(torch.zeros_like(p) if g is None and p is not None
                   else g)
    return tuple(res)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Returns list of (param_var, grad_var) like the reference."""
    program = loss.block.program
    block = program.global_block()
    ops = list(block.ops)

    no_grad = set(no_grad_set or ())

    # requires-grad analysis: forward sweep
    requires = set()
    for v in block.vars.values():
        if v.is_parameter and not v.stop_gradient and v.name not in no_grad:
            requires.add(v.name)
    # explicit targets (gradients wrt arbitrary vars)
    for p in parameter_list or ():
        name = p.name if isinstance(p, Variable) else p
        if name not in no_grad:
            requires.add(name)
    for op in ops:
        if op.fn is None:
            continue
        ins = getattr(op, "in_order", op.input_names())
        if any(n in requires for n in ins):
            for n in getattr(op, "out_order", op.output_names()):
                v = block.vars.get(n)
                # a bool or integer output (a comparison's) carries no
                # gradient
                if v is None or v.dtype.is_floating_point:
                    requires.add(n)

    if loss.name not in requires:
        raise RuntimeError("loss does not depend on any trainable parameter")

    # the loss's gradient: ones (a source op: fn(device=...))
    loss_grad = block.create_var(name=_grad_name(loss.name), shape=loss.shape,
                                 dtype=loss.dtype)
    lshape = tuple(loss.shape or ())
    block.append_op(
        "fill_constant_grad", {}, {"Out": [loss_grad.name]},
        {"shape": list(lshape), "value": 1.0},
        fn=lambda device: torch.ones(lshape, dtype=torch.float32,
                                     device=device),
    )
    block.ops[-1].in_order = []
    block.ops[-1].out_order = [loss_grad.name]

    # which grads exist so far (name -> grad var name)
    have_grad = {loss.name: loss_grad.name}
    acc_count = {}

    for idx in reversed(range(len(ops))):
        op = ops[idx]
        if op.fn is None:
            continue
        out_names = getattr(op, "out_order", op.output_names())
        in_names = getattr(op, "in_order", op.input_names())
        if not any(n in requires for n in in_names):
            continue
        out_grads_avail = [have_grad.get(n) for n in out_names]
        if all(g is None for g in out_grads_avail):
            continue

        diff_idx = [i for i, n in enumerate(in_names) if n in requires]
        if not diff_idx:
            continue

        new_grad_outs = []
        for i in diff_idx:
            src = in_names[i]
            gname = _grad_name(src)
            if src in have_grad or any(s == src for s, _ in new_grad_outs):
                # multi-consumer (another op, or this op's other slot, as
                # in x * x): accumulate
                acc_count[src] = acc_count.get(src, 0) + 1
                gname = f"{_grad_name(src)}@RENAME@{acc_count[src]}"
            if not block.has_var(gname):
                v = block.vars.get(src)
                block.create_var(name=gname, shape=v.shape if v else None,
                                 dtype=v.dtype if v else "float32")
            new_grad_outs.append((src, gname))

        avail_mask = [g is not None for g in out_grads_avail]
        grad_error = getattr(op, "grad_error", None)
        if grad_error is not None:
            def grad_fn(saved, *ogs, _msg=grad_error):
                raise ValueError(_msg)
        else:
            def grad_fn(saved, *ogs, _m=avail_mask):
                return grad_from_saved(saved, _m, ogs)
        gop = block.append_op(
            f"{op.type}_grad",
            {"X": list(in_names), "Out@GRAD": [g for g in out_grads_avail
                                               if g]},
            {"X@GRAD": [g for _, g in new_grad_outs]},
            {}, fn=grad_fn,
        )
        gop.in_order = list(in_names) + [g for g in out_grads_avail if g]
        gop.out_order = [g for _, g in new_grad_outs]
        gop.forward_op = idx
        gop.diff_idx = diff_idx

        for src, gname in new_grad_outs:
            if src in have_grad and gname != _grad_name(src):
                # emit sum op
                prev = have_grad[src]
                summed = f"{_grad_name(src)}@SUM@{acc_count[src]}"
                block.create_var(name=summed,
                                 shape=block.vars[src].shape,
                                 dtype=block.vars[src].dtype)
                sop = block.append_op(
                    "sum", {"X": [prev, gname]}, {"Out": [summed]}, {},
                    fn=lambda a, b: a + b,
                )
                sop.in_order = [prev, gname]
                sop.out_order = [summed]
                have_grad[src] = summed
            else:
                have_grad[src] = gname

    # canonicalize param grads to NAME@GRAD (looked up by name)
    params = parameter_list or [
        v.name for v in block.vars.values() if v.is_parameter
    ]
    result = []
    for pname in params:
        p = block.vars.get(pname if isinstance(pname, str) else pname.name)
        if p is None or p.stop_gradient:
            continue
        g = have_grad.get(p.name)
        if g is None:
            continue
        canonical = _grad_name(p.name)
        if g != canonical:
            if not block.has_var(canonical):
                block.create_var(name=canonical, shape=p.shape, dtype=p.dtype)
            aop = block.append_op("assign", {"X": [g]}, {"Out": [canonical]},
                                  {}, fn=lambda a: a)
            aop.in_order = [g]
            aop.out_order = [canonical]
        result.append((p, block.var(canonical)))
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    pgs = append_backward(targets[0], no_grad_set=no_grad_set,
                          parameter_list=[
                              i.name if isinstance(i, Variable) else i
                              for i in (inputs if isinstance(inputs,
                                                             (list, tuple))
                                        else [inputs])
                          ])
    return [g for _, g in pgs]
