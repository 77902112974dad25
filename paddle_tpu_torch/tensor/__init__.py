"""The ``paddle.tensor`` namespace (``paddle_tpu/tensor/``): the op
library's creation, math and manipulation functions, grouped by family.
``tensor.linalg`` waits for ``ops/linalg_extra.py``."""
from ..ops.creation import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.math import *  # noqa: F401,F403
from . import (creation, logic, manipulation, math, random,  # noqa: F401
               search, stat)
