"""Activation layers.

Port of paddle_tpu/nn/layer/activation.py: each layer calls its
`nn.functional` op.
"""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer


def _simple(fname, cls_name):
    def forward(self, x):
        return getattr(F, fname)(x, **self._kw)

    def __init__(self, **kw):
        Layer.__init__(self)
        kw.pop("name", None)
        self._kw = kw

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "__module__": __name__})


ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
SiLU = _simple("silu", "SiLU")
Swish = _simple("silu", "Swish")
Mish = _simple("mish", "Mish")
Sigmoid = _simple("sigmoid", "Sigmoid")
Tanh = _simple("tanh", "Tanh")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
Softsign = _simple("softsign", "Softsign")
Hardswish = _simple("hardswish", "Hardswish")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
GLU = _simple("glu", "GLU")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Softplus(Layer):
    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from ..initializer import Constant

        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)
