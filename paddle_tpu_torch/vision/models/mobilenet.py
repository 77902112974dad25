"""MobileNet V1 and V2 (``paddle_tpu/vision/models/mobilenet.py``);
depthwise convolutions through ``groups``."""
from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, ReLU,
                   ReLU6, Sequential)
from ...nn import functional as F
from ._place import no_pretrained, start


class ConvBNLayer(nn.Module):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act_cls=ReLU, *, generator):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False,
                           generator=generator, device="cpu")
        self.bn = BatchNorm2D(out_c, device="cpu")
        self.act = act_cls() if act_cls else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_c, out_c1, out_c2, stride, scale=1.0, *,
                 generator):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride=stride, padding=1,
                              groups=in_c, generator=generator)
        self.pw = ConvBNLayer(c1, c2, 1, generator=generator)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    """Built on the CPU from `generator`, moved to `device` (None means
    the card)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 generator=None, device=None):
        super().__init__()
        dev, g = start(device, "MobileNetV1", generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1,
                                 generator=g)
        cfg = [
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1),
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1),
        ]
        self.blocks = Sequential(*[
            DepthwiseSeparable(i, a, b, st, scale, generator=g)
            for i, a, b, st in cfg])
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes, generator=g)
        self.to(dev)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, *, generator):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act_cls=ReLU6,
                                      generator=generator))
        layers.extend([
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act_cls=ReLU6, generator=generator),
            ConvBNLayer(hidden, oup, 1, act_cls=None, generator=generator),
        ])
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    """Built on the CPU from `generator`, moved to `device` (None means
    the card)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 generator=None, device=None):
        super().__init__()
        dev, g = start(device, "MobileNetV2", generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = int(32 * scale)
        self.conv1 = ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                 act_cls=ReLU6, generator=g)
        blocks = []
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t,
                    generator=g))
                input_channel = out_c
        self.blocks = Sequential(*blocks)
        self.last_channel = int(1280 * max(1.0, scale))
        self.conv_last = ConvBNLayer(input_channel, self.last_channel, 1,
                                     act_cls=ReLU6, generator=g)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(self.last_channel, num_classes, generator=g)
        self.to(dev)

    def forward(self, x):
        x = self.conv_last(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
