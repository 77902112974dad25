"""The vision model zoo (``paddle_tpu/vision/``): LeNet, ResNet, VGG and
MobileNet V1/V2 in dygraph.  Datasets and transforms are not ported."""
from . import models

__all__ = ["models"]
