"""``paddle.tensor.stat``: `mean` and `numel` (`std`, `var` and `median`
wait for ``ops/linalg_extra.py``)."""
from ..ops.math import mean  # noqa: F401
from ..ops.math import numel_t as numel  # noqa: F401
