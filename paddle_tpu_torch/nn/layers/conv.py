"""Convolution layers (``paddle_tpu/nn/layers/conv.py``): Conv2D, NCHW
with an OIHW weight.  The 1-D, 3-D and transposed convolutions are not
ported."""
from torch import nn

from .. import functional as F
from ..initializer import KaimingNormal
from ..layer import create_parameter


class Conv2D(nn.Module):
    """Weight [out, in / groups, kh, kw], KaimingNormal by default;
    ``bias_attr=False`` means no bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r} is not ported")
        F._nchw(data_format)
        if isinstance(kernel_size, int):
            kernel_size = [kernel_size] * 2
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = list(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self.weight = create_parameter(
            [out_channels, in_channels // groups] + self._kernel_size,
            weight_attr, default_initializer=KaimingNormal(),
            generator=generator)
        self.bias = create_parameter([out_channels], bias_attr,
                                     is_bias=True, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)
