"""ResNet (``paddle_tpu/vision/models/resnet.py``): BasicBlock,
BottleneckBlock and ResNet-18/34/50/101/152."""
import functools

from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...nn import functional as F
from ._place import no_pretrained, start

# the layers are built on the CPU and the model moves them
_batch_norm = functools.partial(BatchNorm2D, device="cpu")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 generator):
        super().__init__()
        norm_layer = norm_layer or _batch_norm
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, generator=generator, device="cpu")
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            generator=generator, device="cpu")
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 generator):
        super().__init__()
        norm_layer = norm_layer or _batch_norm
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            generator=generator, device="cpu")
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, generator=generator, device="cpu")
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, generator=generator, device="cpu")
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """The stem, four stages of `block` and the classifier; built on the
    CPU from `generator` and moved to `device` (None means the card)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, generator=None, device=None):
        super().__init__()
        dev, g = start(device, "ResNet", generator)
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = _batch_norm
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, generator=g, device="cpu")
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], g)
        self.layer2 = self._make_layer(block, 128, layers[1], g, stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], g, stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], g, stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, generator=g)
        self.to(dev)

    def _make_layer(self, block, planes, blocks, generator, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, generator=generator,
                       device="cpu"),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        generator=generator)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, generator=generator))
        return Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def resnet18(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(BottleneckBlock, 152, **kwargs)
