"""Activation layers (``paddle_tpu/nn/layers/activation.py``)."""
from torch import nn

from .. import functional as F


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return F.relu6(x)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
