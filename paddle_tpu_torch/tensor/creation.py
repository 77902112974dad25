"""``paddle.tensor.creation``: the creation ops."""
from ..ops.creation import *  # noqa: F401,F403
