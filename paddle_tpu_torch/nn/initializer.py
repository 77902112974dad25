"""Weight initializers (``paddle_tpu/nn/initializer.py``): the same
distributions and fans, drawn from an explicit ``torch.Generator``.

Each initializer is ``init(shape, dtype, generator, device="cpu")``.  The
dygraph layers draw on the CPU (``nn/layer.py::create_parameter``) and
then move to their device; a static program's ``init`` ops draw on the
executor's device from its generator.  The values are not the JAX
package's: parity rests on weights carried across, not on equal random
streams.
"""
import math

import numpy as np
import torch


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _needs(generator):
    if generator is None:
        raise ValueError("a random initializer draws from an explicit "
                         "torch.Generator: pass generator=")
    return generator


class Initializer:
    def __call__(self, shape, dtype, generator, device="cpu"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, generator, device="cpu"):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, generator, device="cpu"):
        u = torch.rand(tuple(shape), generator=_needs(generator),
                       dtype=dtype, device=device)
        return u * (self.high - self.low) + self.low


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator, device="cpu"):
        return torch.randn(tuple(shape), generator=_needs(generator),
                           dtype=dtype, device=device) * self.std + self.mean


class TruncatedNormal(Initializer):
    """A standard normal cut at -2 and 2, then scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator, device="cpu"):
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=_needs(generator))
        return t * self.std + self.mean


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype, generator, device="cpu"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, generator, device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype, generator, device="cpu"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = math.sqrt(2.0 / (fi + fo))
        return torch.randn(tuple(shape), generator=_needs(generator),
                           dtype=dtype, device=device) * std


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in

    def __call__(self, shape, dtype, generator, device="cpu"):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = math.sqrt(6.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, generator, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in

    def __call__(self, shape, dtype, generator, device="cpu"):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = math.sqrt(2.0 / fi)
        return torch.randn(tuple(shape), generator=_needs(generator),
                           dtype=dtype, device=device) * std


class Assign(Initializer):
    """A given array (numpy, list or tensor), reshaped to `shape`."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, generator, device="cpu"):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(v)).to(
            dtype=dtype, device=device).reshape(tuple(shape))


MSRAInitializer = KaimingNormal
