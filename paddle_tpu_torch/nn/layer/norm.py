"""Normalization layers.

Port of paddle_tpu/nn/layer/norm.py: `BatchNorm*` (running statistics as
the buffers `_mean` and `_variance`), `LayerNorm` and `RMSNorm` (through
`nn.functional`'s gates: K3-LN and K3 on CUDA tensors with
`FLAGS_pallas_fused_ops` on, `forward_fused_add` their add kinds),
`GroupNorm`, `InstanceNorm*`, `LocalResponseNorm` and `SpectralNorm`.
`amp.decorate` at O2 keeps the layers whose class name starts with
"BatchNorm" or "LayerNorm" in f32, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import op
from ...core.tensor import Tensor
from .. import functional as F
from ..initializer import Constant
from ..layer_base import Layer
from ..utils import _sn_reshape


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                (num_features,),
                attr=None if weight_attr in (None, True) else weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (num_features,),
                attr=None if bias_attr in (None, True) else bias_attr,
                is_bias=True)
        self.register_buffer("_mean", Tensor(np.zeros(num_features,
                                                      np.float32)))
        self.register_buffer("_variance", Tensor(np.ones(num_features,
                                                         np.float32)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
            f"momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("data_format", "NCDHW")
        super().__init__(*args, **kwargs)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm on one card (the reference's equals BatchNorm too: GSPMD
    reduces over the global batch in a compiled step)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                self._normalized_shape,
                attr=None if weight_attr in (None, True) else weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is not False:
            self.bias = self.create_parameter(
                self._normalized_shape,
                attr=None if bias_attr in (None, True) else bias_attr,
                is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def forward_fused_add(self, x, residual):
        """(ln(x + residual), x + residual) by `F.fused_add_layer_norm`
        (one K3-LN launch on a CUDA tensor with the flag on)."""
        if len(self._normalized_shape) != 1:
            raise ValueError("fused add+LayerNorm normalizes the last axis "
                             "only")
        return F.fused_add_layer_norm(x, residual, self.weight, self.bias,
                                      self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, " \
            f"epsilon={self._epsilon}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)

    def forward_fused_add(self, x, residual):
        """(rmsnorm(x + residual), x + residual) by
        `F.fused_add_rms_norm` (one K3 launch)."""
        return F.fused_add_rms_norm(x, residual, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                (num_channels,), default_initializer=Constant(1.0))
        if bias_attr is not False:
            self.bias = self.create_parameter((num_channels,), is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    """Instance norm with a `scale` and a `bias` (no running statistics:
    `momentum` is accepted and unused, as in the reference)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        self.scale = None
        self.bias = None
        if weight_attr is not False:
            self.scale = self.create_parameter(
                (num_features,), default_initializer=Constant(1.0))
        if bias_attr is not False:
            self.bias = self.create_parameter((num_features,), is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


@op("spectral_norm")
def _spectral_divide(w, u, v, dim, eps):
    sigma = u @ _sn_reshape(w, dim) @ v
    return w / torch.clamp_min(sigma, eps)


class SpectralNorm(Layer):
    """forward(weight) = weight / sigma_max, sigma estimated by power
    iteration on the persistent buffers `weight_u` / `weight_v` (their
    start from numpy's RandomState(0), as the reference's)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = epsilon
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        rs = np.random.RandomState(0)
        u = rs.randn(h).astype(dtype)
        v = rs.randn(w).astype(dtype)
        self.register_buffer("weight_u", Tensor(
            u / (np.linalg.norm(u) + epsilon)))
        self.register_buffer("weight_v", Tensor(
            v / (np.linalg.norm(v) + epsilon)))

    def forward(self, weight):
        eps = self._eps
        with torch.no_grad():
            wm = _sn_reshape(weight._data, self._dim)
            u, v = self.weight_u._data, self.weight_v._data
            for _ in range(max(1, self._power_iters)):
                v = wm.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wm @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            self.weight_u._data.copy_(u)
            self.weight_v._data.copy_(v)
        return _spectral_divide(weight, u.clone(), v.clone(), self._dim, eps)
