"""``paddle.tensor.logic``: comparisons and boolean ops."""
from ..ops.math import (allclose, bitwise_and, bitwise_not,  # noqa: F401
                        bitwise_or, bitwise_xor, equal, equal_all,
                        greater_equal, greater_than, isclose, less_equal,
                        less_than, logical_and, logical_not, logical_or,
                        logical_xor, not_equal)
