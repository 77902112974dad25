"""Training steps: a single device in this slice."""
from .hybrid import TrainStep

__all__ = ["TrainStep"]
