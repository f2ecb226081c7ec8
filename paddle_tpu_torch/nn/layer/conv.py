"""Convolution layers.

Port of paddle_tpu/nn/layer/conv.py: weight [out_ch, in_ch / groups,
*kernel] (transposed: [in_ch, out_ch / groups, *kernel]) as Paddle's,
KaimingUniform over the fan-in and a uniform bias in +-1/sqrt(fan_in).
`Conv1DTranspose` runs `conv1d_transpose` (the reference's class raises
"planned").
"""
from __future__ import annotations

import math

import numpy as np

from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from ..layer_base import Layer


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuple(kernel_size, nd)
        self._stride = _tuple(stride, nd)
        self._padding = padding
        self._dilation = _tuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        self._nd = nd
        if transpose:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=None if (weight_attr is not None and getattr(
                weight_attr, "initializer", None))
            else KaimingUniform(fan_in=fan_in))
        self.bias = None
        if bias_attr is not False:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = self.create_parameter(
                (out_channels,),
                attr=None if bias_attr in (None, True) else bias_attr,
                is_bias=True, default_initializer=Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation,
                                  self._data_format, output_size)
