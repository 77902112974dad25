"""Pooling layers (``paddle_tpu/nn/layers/pooling.py``): the max,
average and adaptive pools in 1-D, 2-D and 3-D over `F`'s functions,
with the JAX layers' arguments.  The 1-D and 2-D pools' ``ceil_mode``
and ``return_mask`` and the 2-D ``divisor_override`` raise when called
(the JAX pools ignore them or answer None); the 3-D pools honour
``ceil_mode``, `MaxPool3D` its ``return_mask``."""
from torch import nn

from .. import functional as F


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.df = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.return_mask, self.df)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override, self.df = divisor_override, data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive, self.divisor_override, self.df)


class MaxPool1D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode

    def forward(self, x):
        if self.return_mask:
            raise NotImplementedError("MaxPool1D(return_mask=True) is not "
                                      "ported (the JAX layer ignores it)")
        return F.max_pool1d(x, self.k, self.s, self.p, self.ceil_mode)


class AvgPool1D(nn.Module):
    """`exclusive` is unused: the JAX layer always leaves a padding out
    of the count."""

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.ceil_mode)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.df = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.df)


class AdaptiveMaxPool2D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class MaxPool3D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask

    def forward(self, x):
        return F.max_pool3d(x, self.k, stride=self.s, padding=self.p,
                            ceil_mode=self.ceil_mode,
                            return_mask=self.return_mask)


class AvgPool3D(nn.Module):
    """`exclusive` and `divisor_override` are unused: the JAX layer
    passes neither on."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.avg_pool3d(x, self.k, stride=self.s, padding=self.p,
                            ceil_mode=self.ceil_mode)


class AdaptiveAvgPool1D(nn.Module):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(nn.Module):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
