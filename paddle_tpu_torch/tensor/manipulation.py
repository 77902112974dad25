"""``paddle.tensor.manipulation``: reshape, concat, split and the rest."""
from ..ops.manipulation import *  # noqa: F401,F403
