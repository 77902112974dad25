"""The static graph's IR: Program, Block, Operator and Variable.

The IR is Python metadata, as in the JAX package (``paddle_tpu/static/
program.py``): each Operator carries `fn`, the PyTorch function of
tensors it runs as, and the executor (``executor.py``) runs a block's
ops in program order.  Names come from per-program counters
(``param_N``, ``b_N``, ``bn_mean_N``, ``bn_var_N``, ``tmp_N``) exactly as
the JAX package makes them, so two programs built alike name every
variable alike.  Variable dtypes are ``torch.dtype``s.
"""
import collections
import contextlib
import copy

import torch

from ..dtype import convert_dtype, dtype_name  # noqa: F401

# False under ``paddle.enable_static()`` (the top-level create_parameter
# reads it)
_dygraph_mode = True


class Variable:
    """VarDesc: a named, shaped, typed slot of a block."""

    def __init__(self, block, name, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, is_data=False):
        self.block = block
        self.name = name
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = None  # set for parameters
        self.optimize_attr = {"learning_rate": 1.0}
        self.is_parameter = False
        self.trainable = True

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return f"Var({self.name}: {self.shape} {dtype_name(self.dtype)})"

    # arithmetic on static vars emits elementwise ops
    def _emit(self, op_type, other=None, reverse=False):
        from . import nn_static as NS

        return NS._elementwise_emit(op_type, self, other, reverse)

    def __add__(self, other):
        return self._emit("elementwise_add", other)

    def __radd__(self, other):
        return self._emit("elementwise_add", other, reverse=True)

    def __sub__(self, other):
        return self._emit("elementwise_sub", other)

    def __rsub__(self, other):
        return self._emit("elementwise_sub", other, reverse=True)

    def __mul__(self, other):
        return self._emit("elementwise_mul", other)

    def __rmul__(self, other):
        return self._emit("elementwise_mul", other, reverse=True)

    def __truediv__(self, other):
        return self._emit("elementwise_div", other)

    # comparisons emit bool ops (``__eq__`` stays identity: vars are
    # dict keys)
    def _compare(self, op_type, other):
        from . import nn_static as NS

        return NS._compare_emit(op_type, self, other)

    def __lt__(self, other):
        return self._compare("less_than", other)

    def __le__(self, other):
        return self._compare("less_equal", other)

    def __gt__(self, other):
        return self._compare("greater_than", other)

    def __ge__(self, other):
        return self._compare("greater_equal", other)


Parameter = Variable


class Operator:
    """OpDesc: a type, named input and output var lists and attrs.  `fn`
    is the op's PyTorch function: positional input tensors (in
    ``in_order``) -> a tensor or a tuple of them (in ``out_order``)."""

    def __init__(self, block, op_type, inputs, outputs, attrs=None, fn=None):
        self.block = block
        self.type = op_type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.fn = fn

    def input_names(self):
        return [v for vs in self.inputs.values() for v in vs]

    def output_names(self):
        return [v for vs in self.outputs.values() for v in vs]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"


class Block:
    """BlockDesc: the vars and the ops of one block, in program order.  A
    sub-block (a control-flow branch or body, a StaticRNN step) has its
    parent's index in `parent_idx`; the global block's is -1."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError(f"Variable {name} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return name in self.vars

    def create_var(self, name=None, shape=None, dtype="float32",
                   persistable=False, stop_gradient=False, is_data=False,
                   **kw):
        if name is None:
            name = self.program._unique_name("tmp")
        v = Variable(self, name, shape, dtype, persistable, stop_gradient,
                     is_data)
        self.vars[name] = v
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         initializer=None, **kw):
        v = self.create_var(name=name or self.program._unique_name("param"),
                            shape=shape, dtype=dtype, persistable=True)
        v.is_parameter = True
        v.initializer = initializer
        return v

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  fn=None):
        op = Operator(self, type, inputs, outputs, attrs, fn=fn)
        self.ops.append(op)
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if v.is_parameter]

    def lookup(self, name):
        """The var `name` of this block or the nearest enclosing one (a
        sub-block's capture of a parent's var)."""
        b = self
        while b is not None:
            if b.has_var(name):
                return b.vars[name]
            b = b.program.block(b.parent_idx) if b.parent_idx >= 0 else None
        raise KeyError(f"captured variable {name!r} not found in any "
                       f"enclosing block")


class Program:
    """ProgramDesc: the blocks (the global block, then the sub-blocks that
    control flow and StaticRNN record, each run by one op of its
    parent), the name counters and the startup seed."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._name_counter = collections.Counter()
        self.random_seed = 0
        self._pipeline_opt = None

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    def _unique_name(self, prefix):
        self._name_counter[prefix] += 1
        return f"{prefix}_{self._name_counter[prefix]}"

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False):
        """A deep copy.  ``for_test=True`` makes the inference clone, as
        the JAX package does: every op that reads or writes an ``@GRAD``
        name is pruned (the grad ops and the update ops), ``is_test`` is
        set where an op has it, a training batch norm normalizes by its
        running stats and leaves them as they are, dropout becomes the
        identity (type ``scale``) and the clone advances no dropout step
        counter."""
        p = copy.deepcopy(self)
        if not for_test:
            return p
        for b in p.blocks:
            b.ops = [op for op in b.ops if not any(
                "@GRAD" in n
                for n in (list(getattr(op, "in_order", op.input_names()))
                          + list(getattr(op, "out_order",
                                         op.output_names()))))]
            for op in b.ops:
                if "is_test" in op.attrs:
                    op.attrs["is_test"] = True
                if op.type == "batch_norm" and len(op.out_order) > 1:
                    op.fn = _bn_eval_fn(op.attrs["epsilon"],
                                        op.attrs.get("act"))
                if op.type in ("dropout", "dropout2d", "dropout3d"):
                    op.type = "scale"
                    op.fn = _identity
                    op.in_order = op.in_order[:1]
        p._rng_step_vars = []
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx}:")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    prev_main, prev_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = prev_main
        _startup_program = prev_startup


def name_scope(prefix):
    return contextlib.nullcontext()


def _identity(v):
    return v


def _bn_eval_fn(eps, act):
    """A training batch norm's fn in a for_test clone: the running stats
    normalize (in float32, the output back in the input's dtype, as the
    op's ``is_test`` form does) and pass through as MeanOut and
    VarianceOut unchanged."""
    from .nn_static import _BN_ACTS

    def fn(v, sc, b, m, va):
        shape = [1, v.shape[1]] + [1] * (v.dim() - 2)
        vf = v.float() if v.dtype != torch.float32 else v
        out = (vf - m.reshape(shape)) * torch.rsqrt(va.reshape(shape) + eps)
        out = out * sc.reshape(shape) + b.reshape(shape)
        if act:
            out = _BN_ACTS[act](out)
        return out.to(v.dtype), m, va

    return fn
