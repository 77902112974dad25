"""LeNet (``paddle_tpu/vision/models/lenet.py``)."""
from torch import nn

from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn import functional as F
from ._place import start


class LeNet(nn.Module):
    """Two conv/ReLU/max-pool stages and three linears, for 1x28x28
    images; built on the CPU from `generator` and moved to `device` (None
    means the card)."""

    def __init__(self, num_classes=10, *, generator=None, device=None):
        super().__init__()
        dev, g = start(device, "LeNet", generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=g, device="cpu"),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=g, device="cpu"),
            ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, generator=g),
                                 Linear(120, 84, generator=g),
                                 Linear(84, num_classes, generator=g))
        self.to(dev)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x
