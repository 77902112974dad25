"""VGG (``paddle_tpu/vision/models/vgg.py``): VGG-11/13/16/19."""
import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...nn import functional as F
from ._place import no_pretrained, start

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, generator):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_channels, v, 3, padding=1,
                                 generator=generator, device="cpu"))
            if batch_norm:
                layers.append(BatchNorm2D(v, device="cpu"))
            layers.append(ReLU())
            in_channels = v
    return Sequential(*layers)


class VGG(nn.Module):
    """`features`, a 7x7 adaptive pool and the classifier, whose two
    Dropouts draw, in train mode, from generators on the input's device
    seeded from `generator`; moved to `device` (None means the card)."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 generator=None, device=None):
        super().__init__()
        dev, g = start(device, "VGG", generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            seeds = torch.randint(2**62, (2,), generator=g).tolist()
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, generator=g),
                ReLU(),
                Dropout(seed=seeds[0]),
                Linear(4096, 4096, generator=g),
                ReLU(),
                Dropout(seed=seeds[1]),
                Linear(4096, num_classes, generator=g))
        self.to(dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def _vgg(cfg, pretrained, batch_norm, generator=None, **kwargs):
    no_pretrained(pretrained)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return VGG(make_layers(cfgs[cfg], batch_norm, generator=generator),
               generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)
