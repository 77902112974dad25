"""Static utility ops and the StaticRNN builder
(``paddle_tpu/static/extras.py``): `Print`, `Assert`, `select_input`,
`select_output`, `assign_value` and `StaticRNN`.  ``py_func`` is not
ported yet.

A StaticRNN's step is recorded into a sub-block, as control flow's
branches are (``controlflow.py``), and one ``recurrent`` op runs it: its
`fn` walks the time axis in Python over the sub-block, the memories its
carry, each step input the slice of its sequence at that step, the step
outputs stacked on a new leading axis.  The JAX package lowers the same
sub-block to one ``lax.scan``; gradients here come from autograd through
the walk (``backward.forward_saving``).
"""
import contextlib

import numpy as np
import torch

from .controlflow import _block_fn, _captures, _sub_block
from .nn_static import emit, fill_constant
from .program import convert_dtype, default_main_program

__all__ = ["Assert", "Print", "StaticRNN", "assign_value", "select_input",
           "select_output"]


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both", name=None):
    """Print the var's value when the op runs (read back to the host) and
    pass it through, so that ops after it keep their input."""
    msg = message or ""
    tag = f"{msg}{input.name if print_tensor_name else ''}"

    def fn(v):
        print(f"{tag} = {v.detach().cpu()}")
        return v

    return emit("print", [("In", input)], [("Out", input.shape, input.dtype)],
                fn, attrs={"message": msg})


def Assert(cond, data=None, summarize=20, name=None):
    """Raise RuntimeError when `cond` is not all true as the op runs (read
    back to the host), with the first `summarize` values of each `data`
    var; the op's output is an int32 0."""
    data_vars = list(data or [])

    def fn(c, *vals):
        if not bool(c.all()):
            detail = ", ".join(str(d.detach().cpu().reshape(-1)[:summarize]
                                   .numpy()) for d in vals)
            raise RuntimeError(
                f"Assert failed{': ' + detail if detail else ''}")
        return torch.zeros((), dtype=torch.int32, device=c.device)

    ins = [("Cond", cond)] + [("Data", d) for d in data_vars]
    return emit("assert", ins, [("Out", [], "int32")], fn,
                attrs={"summarize": summarize})


def select_input(inputs, mask):
    """The input that `mask` indexes (clipped to the inputs; no host
    read); all inputs share a shape and dtype."""
    n = len(inputs)

    def fn(m, *vals):
        idx = m.reshape(1).to(torch.int64).clamp(0, n - 1)
        return torch.index_select(torch.stack(vals), 0, idx)[0]

    x0 = inputs[0]
    return emit("select_input",
                [("Mask", mask)] + [("X", v) for v in inputs],
                [("Out", x0.shape, x0.dtype)], fn)


def select_output(input, outputs, mask):
    """`input` to the output `mask` indexes, zeros to the others."""
    n = len(outputs)

    def fn(m, v):
        idx = m.reshape(()).to(torch.int64)
        return tuple(torch.where(idx == i, v, torch.zeros_like(v))
                     for i in range(n))

    return emit("select_output", [("Mask", mask), ("X", input)],
                [("Out", input.shape, input.dtype) for _ in range(n)], fn)


def assign_value(shape, dtype, values, name=None):
    """A host constant in the program (a source op)."""
    dt = convert_dtype(dtype)
    arr = np.asarray(values).reshape(shape)

    def fn(device):
        return torch.as_tensor(arr).to(device=device, dtype=dt)

    return emit("assign_value", [], [("Out", list(arr.shape), dtype)], fn,
                attrs={"shape": list(arr.shape), "dtype": dtype})


class StaticRNN:
    """The step-block RNN builder::

        rnn = StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)          # x is [T, B, ...], time-major
            prev = rnn.memory(init=h0)        # the carried state
            hidden = static.nn.fc(...)        # ops recorded in the step
            rnn.update_memory(prev, hidden)
            rnn.step_output(hidden)
        outs = rnn()                          # [T, B, H], stacked steps
    """

    def __init__(self, name=None):
        self._blk = None
        self._step_inputs = []   # (step var, full var)
        self._memories = []      # (memory var, init var)
        self._updates = {}       # memory var name -> new var name
        self._outputs = []       # step-block vars
        self._result = None
        self._in_step = False

    @contextlib.contextmanager
    def step(self):
        with _sub_block() as blk:
            self._blk = blk
            self._in_step = True
            try:
                yield self
            finally:
                self._in_step = False
        self._emit()

    def _require_step(self):
        if not self._in_step:
            raise RuntimeError("StaticRNN.* must be called inside "
                               "`with rnn.step():`")

    def step_input(self, x):
        """Declare a [T, ...] sequence; returns its per-step slice var."""
        self._require_step()
        v = self._blk.create_var(shape=list(x.shape[1:]), dtype=x.dtype)
        self._step_inputs.append((v, x))
        return v

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32"):
        """Declare a carried state from an `init` var, or a `shape` filled
        with `value` whose -1 dims take `batch_ref`'s first dim (a
        ``fill_constant`` op in the parent block)."""
        self._require_step()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs init= or shape=+batch_ref=")
            full = [batch_ref.shape[0] if d == -1 else d for d in shape]
            prog = default_main_program()
            cur = prog.current_block_idx
            prog.current_block_idx = self._blk.parent_idx
            try:
                init = fill_constant(full, dtype, value)
            finally:
                prog.current_block_idx = cur
        v = self._blk.create_var(shape=list(init.shape), dtype=init.dtype)
        self._memories.append((v, init))
        return v

    def update_memory(self, mem, new):
        self._require_step()
        self._updates[mem.name] = new.name

    def step_output(self, o):
        self._require_step()
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _emit(self):
        if not self._step_inputs:
            raise ValueError("StaticRNN needs at least one step_input")
        if not self._outputs:
            raise ValueError("StaticRNN needs at least one step_output")
        for mem_v, _ in self._memories:
            if mem_v.name not in self._updates:
                raise ValueError(
                    f"memory {mem_v.name!r} was never update_memory()-ed")
        step_names = [v.name for v, _ in self._step_inputs]
        mem_names = [v.name for v, _ in self._memories]
        out_names = [o.name for o in self._outputs]
        cap_names = [n for n in _captures(self._blk)
                     if n not in step_names and n not in mem_names]
        run = _block_fn(self._blk,
                        [self._updates[n] for n in mem_names] + out_names,
                        mem_names + step_names + cap_names)
        n_mem, n_step = len(mem_names), len(step_names)

        def fn(*vals):
            seqs = vals[:n_step]
            carry = tuple(vals[n_step:n_step + n_mem])
            caps = tuple(vals[n_step + n_mem:])
            steps = [[] for _ in out_names]
            for t in range(seqs[0].shape[0]):
                res = run(carry + tuple(s[t] for s in seqs) + caps,
                          seqs[0].device)
                carry = res[:n_mem]
                for acc, v in zip(steps, res[n_mem:]):
                    acc.append(v)
            stacked = tuple(torch.stack(acc) for acc in steps)
            return stacked if len(stacked) != 1 else stacked[0]

        block = default_main_program().current_block()
        ins = ([("X", full) for _, full in self._step_inputs]
               + [("Mem", init) for _, init in self._memories]
               + [("Captured", block.lookup(n)) for n in cap_names])
        T = self._step_inputs[0][1].shape[0]
        res = emit("recurrent", ins,
                   [("Out", [T] + list(o.shape), o.dtype)
                    for o in self._outputs], fn,
                   attrs={"sub_block": self._blk.idx})
        self._result = res if isinstance(res, list) else [res]

    def __call__(self):
        if self._result is None:
            raise RuntimeError("StaticRNN block not built yet")
        return self._result if len(self._result) != 1 else self._result[0]
