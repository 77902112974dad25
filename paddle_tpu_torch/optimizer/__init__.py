"""Optimizers of the training slice."""
from .optimizer import Adam, AdamW

__all__ = ["Adam", "AdamW"]
