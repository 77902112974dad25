"""Containers (``paddle_tpu/nn/layers/container.py``): PyTorch's own,
whose children are keyed "0", "1", ... (or by the given keys) as in the
JAX package, so names like ``features.0.weight`` match."""
from torch import nn

Sequential = nn.Sequential
LayerList = nn.ModuleList
LayerDict = nn.ModuleDict
ParameterList = nn.ParameterList
