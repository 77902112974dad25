"""``paddle.tensor.math``: elementwise and reduction math."""
from ..ops.math import *  # noqa: F401,F403
