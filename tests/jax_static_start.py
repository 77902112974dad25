"""The start scope of a JAX static program without its random draws, for
the port's parity tests, which carry that scope to the port anyway.

The JAX package's random initializers compile once per shape, about half
a second each on one core.  `numpy_start` runs each ``init`` op of a JAX
startup program as the executor would, but one whose var has a random
initializer gets a seeded numpy normal draw scaled by 1/sqrt(its fan in)
instead; constants and optimizer states run as they are."""
import numpy as np

from paddle_tpu.nn.initializer import Constant


def numpy_start(startup, seed=0):
    """``{name: numpy array}`` of every var `startup`'s init ops make."""
    rng = np.random.default_rng(seed)
    block = startup.global_block()
    start = {}
    for op in block.ops:
        if op.type != "init" or op.fn is None:
            continue
        name = op.outputs["Out"][0]
        var = block.vars.get(name)
        init = getattr(var, "initializer", None)
        if init is None or isinstance(init, Constant):
            start[name] = np.asarray(op.fn())
            continue
        shape = tuple(var.shape)
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        start[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.dtype(var.dtype))
    return start
