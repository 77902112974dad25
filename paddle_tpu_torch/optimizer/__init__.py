"""The optimizers (eager step, compiled step, static minimize) and the LR
schedulers."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        L1Decay, L2Decay, Lamb, Momentum, Optimizer, RMSProp)

__all__ = ["SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "L1Decay", "L2Decay", "Lamb", "Momentum", "Optimizer", "RMSProp",
           "lr"]
