"""Dygraph AMP (``paddle_tpu/amp/auto_cast.py``): the thread-local
state, the white and black lists, `auto_cast` and `decorate`, and
`cast_inputs`, the cast at op entry.

The JAX package casts inside its op dispatcher (``core/registry.py::
apply_op``); the port has no op registry, so each port counterpart of a
JAX op calls `cast_inputs` with the JAX op's name.  The rule is JAX's:
with AMP on and the op to be cast, every float32 tensor argument becomes
the AMP dtype (a bias and an additive mask too), and nothing else
changes.  The black list casts nothing up: it only exempts an op from
O2 and from a custom white list.  The cast is differentiable, so a
float32 parameter gets a float32 gradient.

This is not ``torch.autocast``, whose lists and promotion rules are
not the JAX package's.  The compiled train steps (``parallel.hybrid``)
have their own AMP rule (``amp_cast``); the state here is off in them
unless a caller turns it on around them."""
import contextlib
import threading

import torch

# ops that run in the AMP dtype (the JAX package's allow list)
WHITE_LIST = {
    "conv2d", "conv1d", "conv2d_transpose", "matmul_v2", "bmm", "linear",
    "linear_nobias", "mul", "sdp_attention", "flash_attention",
}
# numerically sensitive ops, never cast (the JAX package's block list)
BLACK_LIST = {
    "softmax_with_cross_entropy", "cross_entropy", "layer_norm", "batch_norm",
    "reduce_mean", "reduce_sum", "exp", "log", "softmax", "log_softmax",
    "p_norm", "amp_cast",
}

white_list = WHITE_LIST
black_list = BLACK_LIST

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}

_state = threading.local()


def _amp_state():
    if not hasattr(_state, "enabled"):
        _state.enabled = False
        _state.dtype = "bfloat16"
        _state.level = "O1"
        _state.custom_white = set()
        _state.custom_black = set()
    return _state


def amp_enabled():
    return _amp_state().enabled


def amp_dtype():
    """The torch dtype AMP casts to: bfloat16, or float16 where
    `auto_cast` was given ``dtype="float16"``."""
    return _DTYPES[_amp_state().dtype]


def amp_should_cast(op_type):
    s = _amp_state()
    if not s.enabled:
        return False
    if op_type in s.custom_black or op_type in BLACK_LIST:
        return False
    if s.level == "O2":
        return True
    return op_type in WHITE_LIST or op_type in s.custom_white


def cast_inputs(op_type, *tensors):
    """`tensors` as the JAX op `op_type` receives them: each float32
    tensor in the AMP dtype when AMP is on and `amp_should_cast`, every
    other argument (None, an integer tensor, another float dtype) as it
    is."""
    if not amp_should_cast(op_type):
        return tensors
    dt = amp_dtype()
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float32 else t for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """AMP on (or off, with ``enable=False``) inside the block, at `level`
    O1 (the white list and `custom_white_list`) or O2 (every op not
    black-listed); the state before is restored on exit."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"unknown AMP level {level!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"unknown AMP dtype {dtype!r}")
    s = _amp_state()
    prev = (s.enabled, s.dtype, s.level, s.custom_white, s.custom_black)
    s.enabled = enable
    s.dtype = dtype
    s.level = level
    s.custom_white = set(custom_white_list or ())
    s.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        s.enabled, s.dtype, s.level, s.custom_white, s.custom_black = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts every parameter and every floating buffer of `models` (a
    module or a list) to `dtype` in place, as the JAX ``Layer.to`` does;
    O1 changes nothing.  Returns `models`, or ``(models, optimizers)``
    when `optimizers` is given."""
    if level == "O2":
        dt = _DTYPES[dtype]
        items = models if isinstance(models, (list, tuple)) else [models]
        with torch.no_grad():
            for m in items:
                for p in m.parameters():
                    p.data = p.data.to(dt)
                for b in m.buffers():
                    if b.is_floating_point():
                        b.data = b.data.to(dt)
    if optimizers is None:
        return models
    return models, optimizers
