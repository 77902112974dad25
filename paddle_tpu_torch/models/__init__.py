"""Models of the training slice."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt2_medium,
                  gpt2_small, gpt_tiny)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "gpt2_medium",
           "gpt2_small", "gpt_tiny"]
