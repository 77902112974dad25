"""The start scope of a JAX static program without its random draws, for
the port's parity tests, which carry that scope to the port anyway.

The JAX package's random initializers compile once per shape, about half
a second each on one core.  `numpy_start` runs each ``init`` op of a JAX
startup program as the executor would, but one whose var has a random
initializer gets a seeded numpy normal draw scaled by 1/sqrt(its fan in)
instead; constants and optimizer states run as they are.  Dygraph
layers and models build under `numpy_initializers` for the same
reason."""
import contextlib
import math

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


def _put(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, dtype=np.dtype(dtype)))


@contextlib.contextmanager
def numpy_initializers(seed=0):
    """The JAX package's initializers drawing from a seeded numpy
    generator, with their own distributions and scales, inside the
    block: JAX layers and models build without one compile per
    parameter shape.  The port's tests carry the JAX state across, so
    the values only need to be realistic."""
    from paddle_tpu.nn import initializer as init

    rng = np.random.default_rng(seed)

    def fans(self, shape):
        fi, fo = init._fans(shape)
        return (getattr(self, "fan_in", None) or fi,
                getattr(self, "fan_out", None) or fo)

    def truncated(shape):
        draw = rng.standard_normal(shape)
        return np.clip(draw, -2.0, 2.0)

    draws = {
        init.Constant: lambda self, s: np.full(s, self.value),
        init.Uniform: lambda self, s: rng.uniform(self.low, self.high, s),
        init.Normal: lambda self, s: rng.standard_normal(s) * self.std
        + self.mean,
        init.TruncatedNormal: lambda self, s: truncated(s) * self.std
        + self.mean,
        init.XavierUniform: lambda self, s: rng.uniform(-1, 1, s) * math.sqrt(
            6.0 / sum(fans(self, s))),
        init.XavierNormal: lambda self, s: rng.standard_normal(s) * math.sqrt(
            2.0 / sum(fans(self, s))),
        init.KaimingUniform: lambda self, s: rng.uniform(-1, 1, s) * math.sqrt(
            6.0 / fans(self, s)[0]),
        init.KaimingNormal: lambda self, s: rng.standard_normal(s) * math.sqrt(
            2.0 / fans(self, s)[0]),
    }
    saved = {cls: cls.__call__ for cls in draws}
    try:
        for cls, draw in draws.items():
            cls.__call__ = (lambda draw: lambda self, shape, dtype="float32":
                            _put(draw(self, tuple(shape)), dtype))(draw)
        yield
    finally:
        for cls, call in saved.items():
            cls.__call__ = call
