"""Pooling layers (``paddle_tpu/nn/layers/pooling.py``): MaxPool2D,
AvgPool2D and AdaptiveAvgPool2D, NCHW.  ``ceil_mode``, ``return_mask``
and ``divisor_override`` raise when called (the JAX pools ignore them or
answer None)."""
from torch import nn

from .. import functional as F


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.df = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.return_mask, self.df)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW"):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override, self.df = divisor_override, data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive, self.divisor_override, self.df)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size, self.df = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.df)
