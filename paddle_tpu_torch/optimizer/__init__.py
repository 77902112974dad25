"""The compiled train step's update rules and the LR schedulers."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp)

__all__ = ["SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Lamb",
           "Momentum", "Optimizer", "RMSProp", "lr"]
