"""The ``paddle.callbacks`` namespace: the callbacks of
``hapi.callbacks``."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,
                             ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"]
