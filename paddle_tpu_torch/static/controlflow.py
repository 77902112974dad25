"""Static control flow (``paddle_tpu/static/controlflow.py``): `cond`,
`while_loop`, `switch_case` and `case`.

Each branch or body is recorded into a sub-block of the program (a
`Block` whose ``parent_idx`` is the block it was built in), and one op
in the parent block runs it: its `fn` runs the sub-block's recorded ops
in Python (`_block_fn`), over the parent values the sub-block reads
(`_captures`).  The JAX package compiles the same sub-blocks into
``lax.cond``, ``lax.while_loop`` and ``lax.switch``; here a branch is
picked from a predicate or index read back to the host, and a loop's
condition is read back every iteration, so on the card each of those
reads waits for the work before it.

Gradients go through the parent op like any other op's
(``backward.forward_saving``): autograd records the ops of the branch
that ran, and a capture the branch did not read gets a zero gradient,
as ``jax.vjp`` of ``lax.cond`` gives.  ``jax.vjp`` of ``lax.while_loop``
raises, so the JAX executor raises when a program differentiates
through a `while_loop`; the port's grad op of a ``while`` op raises the
same ValueError when it runs.
"""
import contextlib

import torch

from .nn_static import emit
from .program import Block, Variable, default_main_program

__all__ = ["case", "cond", "switch_case", "while_loop"]

WHILE_GRAD_ERROR = (
    "Reverse-mode differentiation does not work for static.nn.while_loop "
    "(the JAX package's lax.while_loop raises the same): compute the "
    "loop's result without a gradient, or use StaticRNN over a fixed "
    "length")


@contextlib.contextmanager
def _sub_block(program=None):
    """Append a block to `program` and make it current while a branch is
    built in it."""
    program = program or default_main_program()
    parent_idx = program.current_block_idx
    blk = Block(program, len(program.blocks), parent_idx=parent_idx)
    program.blocks.append(blk)
    program.current_block_idx = blk.idx
    try:
        yield blk
    finally:
        program.current_block_idx = parent_idx


def _block_fn(blk, out_names, cap_names):
    """The recorded block `blk` as a function: the values of `cap_names`
    (a tuple) and the run's device (a source op's, one with no inputs)
    -> the values of `out_names` (a tuple)."""
    ops = [op for op in blk.ops if op.fn is not None]

    def run(cap_vals, device):
        env = dict(zip(cap_names, cap_vals))
        for op in ops:
            if op.in_order:
                res = op.fn(*[env[n] for n in op.in_order])
            else:
                res = op.fn(device=device)
            if not isinstance(res, tuple):
                res = (res,)
            env.update(zip(op.out_order, res))
        return tuple(env[n] for n in out_names)

    return run


def _captures(blk):
    """The names a sub-block reads but does not produce: the parent
    values its op runs over."""
    produced, caps = set(), []
    for op in blk.ops:
        for n in op.in_order:
            if n not in produced and n not in caps:
                caps.append(n)
        produced.update(op.out_order)
    return caps


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _build_branch(fn, args=()):
    """Record `fn(*args)` into a new sub-block: (the block, its output
    vars)."""
    with _sub_block() as blk:
        outs = _as_list(fn(*args))
        for o in outs:
            if not isinstance(o, Variable):
                raise TypeError(
                    "control-flow branch functions must return static "
                    f"Variables, got {type(o).__name__}")
    return blk, outs


def _union_captures(blocks, skip=()):
    names = []
    for blk in blocks:
        for n in _captures(blk):
            if n not in names and n not in skip:
                names.append(n)
    return names


def _flag(v):
    """A predicate's value read back to the host."""
    return bool(v.reshape(()))


def cond(pred, true_fn, false_fn, name=None):
    """One ``conditional_block`` op: runs the branch `pred` picks (read
    back to the host) over the captures of both."""
    t_blk, t_outs = _build_branch(true_fn)
    f_blk, f_outs = _build_branch(false_fn)
    if len(t_outs) != len(f_outs):
        raise ValueError(
            f"cond branches must return the same number of outputs "
            f"({len(t_outs)} vs {len(f_outs)})")
    block = default_main_program().current_block()
    cap_names = _union_captures([t_blk, f_blk])
    t_run = _block_fn(t_blk, [o.name for o in t_outs], cap_names)
    f_run = _block_fn(f_blk, [o.name for o in f_outs], cap_names)

    def fn(pred_val, *caps):
        return (t_run if _flag(pred_val) else f_run)(caps, pred_val.device)

    ins = [("Cond", pred)] + [("Input", block.lookup(n)) for n in cap_names]
    return emit("conditional_block", ins,
                [("Out", o.shape, o.dtype) for o in t_outs], fn,
                attrs={"sub_block_true": t_blk.idx,
                       "sub_block_false": f_blk.idx})


def while_loop(cond_fn, body_fn, loop_vars, name=None):
    """One ``while`` op: the loop vars thread through the body while the
    condition (read back to the host each iteration) holds; other
    captures stay fixed.  Its outputs as a list.  No gradient (see the
    module's docstring)."""
    loop_vars = _as_list(loop_vars)
    state_names = [v.name for v in loop_vars]
    c_blk, c_outs = _build_branch(cond_fn, loop_vars)
    if len(c_outs) != 1:
        raise ValueError("while_loop cond must return a single boolean")
    b_blk, b_outs = _build_branch(body_fn, loop_vars)
    if len(b_outs) != len(loop_vars):
        raise ValueError(
            f"while_loop body must return one value per loop var "
            f"({len(b_outs)} vs {len(loop_vars)})")
    cap_names = _union_captures([c_blk, b_blk], skip=state_names)
    c_run = _block_fn(c_blk, [c_outs[0].name], state_names + cap_names)
    b_run = _block_fn(b_blk, [o.name for o in b_outs],
                      state_names + cap_names)
    n_state = len(state_names)

    def fn(*vals):
        state, caps = tuple(vals[:n_state]), tuple(vals[n_state:])
        dev = vals[0].device
        while _flag(c_run(state + caps, dev)[0]):
            state = b_run(state + caps, dev)
        return state

    block = default_main_program().current_block()
    ins = [("X", v) for v in loop_vars] + \
          [("Captured", block.lookup(n)) for n in cap_names]
    res = emit("while", ins, [("Out", v.shape, v.dtype) for v in loop_vars],
               fn, attrs={"sub_block_cond": c_blk.idx,
                          "sub_block_body": b_blk.idx})
    block.ops[-1].grad_error = WHILE_GRAD_ERROR
    return res if isinstance(res, list) else [res]


def switch_case(branch_index, branch_fns, default=None, name=None):
    """One ``switch_case`` op over `branch_fns` (callables, keyed 0..n-1,
    or (key, callable) pairs): the branch whose key equals the index (read
    back to the host) runs; an unmatched index runs `default`, else the
    branch of the largest key."""
    if isinstance(branch_fns, dict):
        branch_fns = list(branch_fns.items())
    if isinstance(branch_fns, (list, tuple)) and branch_fns and \
            isinstance(branch_fns[0], (list, tuple)):
        pairs = sorted(branch_fns, key=lambda kv: kv[0])
        keys = [k for k, _ in pairs]
        fns = [f for _, f in pairs]
    else:
        fns = list(branch_fns)
        keys = list(range(len(fns)))
    if default is not None:
        fns = fns + [default]
    blocks, outs = zip(*(_build_branch(f) for f in fns))
    n_out = len(outs[0])
    for o in outs[1:]:
        if len(o) != n_out:
            raise ValueError("switch_case branches must return the same "
                             "number of outputs")
    cap_names = _union_captures(blocks)
    runs = [_block_fn(blk, [o.name for o in outs_i], cap_names)
            for blk, outs_i in zip(blocks, outs)]
    pos_of = {k: i for i, k in enumerate(keys)}

    def fn(idx_val, *caps):
        idx = int(idx_val.reshape(()).to(torch.int32))
        return runs[pos_of.get(idx, len(runs) - 1)](caps, idx_val.device)

    block = default_main_program().current_block()
    ins = [("Index", branch_index)] + \
          [("Input", block.lookup(n)) for n in cap_names]
    return emit("switch_case", ins,
                [("Out", o.shape, o.dtype) for o in outs[0]], fn,
                attrs={"keys": keys})


def case(pred_fn_pairs, default=None, name=None):
    """One ``case`` op: the branch of the first true predicate (all read
    back to the host) runs, else `default` (without one, the last pair's
    callable is the default)."""
    preds = [p for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    if default is None:
        default = fns[-1]
        fns = fns[:-1]
        preds = preds[:-1]
        if not preds:
            raise ValueError("case needs at least one (pred, fn) plus a "
                             "default (or two pairs)")
    blocks, outs = zip(*(_build_branch(f) for f in list(fns) + [default]))
    cap_names = _union_captures(blocks)
    runs = [_block_fn(blk, [o.name for o in outs_i], cap_names)
            for blk, outs_i in zip(blocks, outs)]
    n_pred = len(preds)

    def fn(*vals):
        flags = [_flag(p) for p in vals[:n_pred]]
        pos = flags.index(True) if any(flags) else len(runs) - 1
        return runs[pos](vals[n_pred:], vals[0].device)

    block = default_main_program().current_block()
    ins = [("Pred", p) for p in preds] + \
          [("Input", block.lookup(n)) for n in cap_names]
    return emit("case", ins, [("Out", o.shape, o.dtype) for o in outs[0]],
                fn, attrs={})
