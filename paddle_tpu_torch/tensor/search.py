"""``paddle.tensor.search``: argmax, topk, where and the rest."""
from ..ops.manipulation import index_sample, index_select  # noqa: F401
from ..ops.math import (argmax, argmin, argsort, masked_select,  # noqa: F401
                        nonzero, sort, topk, where)
