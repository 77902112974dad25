"""``paddle.tensor.random``: the random creation ops."""
from ..ops.creation import (bernoulli, multinomial, normal,  # noqa: F401
                            rand, randint, randn, randperm, uniform)
