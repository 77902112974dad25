"""Weight-decay descriptors (``paddle_tpu/regularizer.py``), given to an
optimizer's ``weight_decay`` or a ``ParamAttr(regularizer=...)``."""
from .optimizer.optimizer import L1Decay, L2Decay

__all__ = ["L1Decay", "L2Decay"]
