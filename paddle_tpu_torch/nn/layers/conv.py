"""Convolution layers (``paddle_tpu/nn/layers/conv.py``): Conv1D,
Conv2D, Conv3D and the transposed Conv1DTranspose, Conv2DTranspose and
Conv3DTranspose.  A convolution's weight is [out, in / groups, *k], a
transposed one's [in, out / groups, *k], KaimingNormal by default;
``bias_attr=False`` means no bias.  Each is built on `device`, where
None means the card, as the vision models are."""
from torch import nn

from .. import functional as F
from ..initializer import KaimingNormal
from ..layer import create_parameter, place


def _refuse_padding_mode(padding_mode):
    if padding_mode != "zeros":
        raise NotImplementedError(
            f"padding_mode={padding_mode!r} is not ported (the JAX layers "
            f"pad with zeros whatever it says)")


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, nd, transpose=False, output_padding=0,
                 generator=None, device=None):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = [kernel_size] * nd
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = list(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self._output_padding = output_padding
        shape = ([in_channels, out_channels // groups] if transpose
                 else [out_channels, in_channels // groups])
        self.weight = create_parameter(
            shape + self._kernel_size, weight_attr,
            default_initializer=KaimingNormal(), generator=generator)
        self.bias = create_parameter([out_channels], bias_attr,
                                     is_bias=True, generator=generator)
        place(self, device)


class Conv2D(_ConvNd):
    """NCHW or NHWC input, an OIHW weight."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator=None, device=None):
        _refuse_padding_mode(padding_mode)
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, generator=generator,
                         device=device)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 generator=None, device=None):
        _refuse_padding_mode(padding_mode)
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, generator=generator,
                         device=device)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 generator=None, device=None):
        _refuse_padding_mode(padding_mode)
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, generator=generator,
                         device=device)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv2DTranspose(_ConvNd):
    """``forward(x, output_size=None)``: `output_size` sets the output
    padding that reaches it."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, transpose=True,
                         output_padding=output_padding, generator=generator,
                         device=device)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups,
            output_size=output_size, data_format=self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 generator=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, transpose=True,
                         output_padding=output_padding, generator=generator,
                         device=device)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups,
            output_size=output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 generator=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, transpose=True,
                         output_padding=output_padding, generator=generator,
                         device=device)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups,
            output_size=output_size)
