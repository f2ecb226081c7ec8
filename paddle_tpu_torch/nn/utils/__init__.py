"""paddle.nn.utils: weight_norm / remove_weight_norm, spectral_norm,
parameters_to_vector / vector_to_parameters, clip_grad_norm_ /
clip_grad_value_.

Port of paddle_tpu/nn/utils/__init__.py. The reparameterizations install
forward pre-hooks that recompute the effective weight from the
decomposed parameters with ops of the Tensor API, so gradients reach (g,
v) and the weight is part of a captured step.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import op
from ...core.tensor import Parameter, Tensor
from ..clip import clip_grad_norm_, clip_grad_value_  # noqa: F401

__all__ = [
    "weight_norm", "remove_weight_norm", "spectral_norm",
    "parameters_to_vector", "vector_to_parameters",
    "clip_grad_norm_", "clip_grad_value_",
]


def _norm_except(w, dim):
    """||w|| over every axis except `dim` (kept)."""
    if dim is None:
        return torch.sqrt((w * w).sum())
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt((w * w).sum(axes, keepdim=True))


@op("weight_norm_recompute")
def _wn_compute(g, v, dim):
    return g * v / torch.clamp_min(_norm_except(v, dim), 1e-12)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize `layer.<name>` as g * v / ||v||, recomputed by a
    forward pre-hook at each call."""
    if hasattr(layer, f"{name}_g"):
        raise ValueError(f"weight_norm already applied to {name}")
    if name not in layer._parameters:
        raise ValueError(f"{name} is not a Parameter of the layer")
    w = layer._parameters[name]._data.detach()
    g = Parameter(_norm_except(w, dim).clone(), _internal=True)
    v = Parameter(w.clone(), _internal=True)
    del layer._parameters[name]
    layer.__dict__.pop(name, None)
    layer.add_parameter(f"{name}_g", g)
    layer.add_parameter(f"{name}_v", v)

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, _wn_compute(
            getattr(lyr, f"{name}_g"), getattr(lyr, f"{name}_v"), dim))
        return inputs

    hook(layer, None)
    h = layer.register_forward_pre_hook(hook)
    layer._weight_norm_hooks = getattr(layer, "_weight_norm_hooks", {})
    layer._weight_norm_hooks[name] = (h, dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    hooks = getattr(layer, "_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm not applied to {name}")
    h, dim = hooks.pop(name)
    h.remove()
    g = layer._parameters.pop(f"{name}_g")
    v = layer._parameters.pop(f"{name}_v")
    with torch.no_grad():
        w = _wn_compute(g._data, v._data, dim).clone()
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w, _internal=True))
    return layer


def _sn_reshape(w, dim):
    """`dim` to the front, the rest flattened: [d, prod(rest)]."""
    if dim != 0:
        w = w.movedim(dim, 0)
    return w.reshape(w.shape[0], -1)


@op("spectral_norm_recompute")
def _sn_divide(w, u, v, dim, eps):
    sigma = u @ _sn_reshape(w, dim) @ v
    return w / torch.clamp_min(sigma, eps)


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide `layer.<name>` by its largest singular value, estimated by
    power iteration on a persistent `u` (its start from numpy's
    RandomState(0), as the reference's)."""
    if dim is None:
        dim = 1 if type(layer).__name__ in (
            "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
            "Linear") else 0
    w = getattr(layer, name)
    wm = _sn_reshape(w._data.detach(), dim)
    rs = np.random.RandomState(0)
    u0 = rs.randn(wm.shape[0]).astype(np.float32)
    u0 /= np.linalg.norm(u0) + eps
    layer.register_buffer(f"{name}_u", Tensor(
        torch.from_numpy(u0).to(device=wm.device, dtype=wm.dtype),
        _internal=True), persistable=True)
    orig = layer._parameters.pop(name)
    layer.__dict__.pop(name, None)
    layer.add_parameter(f"{name}_orig", orig)

    def hook(lyr, inputs):
        worig = getattr(lyr, f"{name}_orig")
        ub = getattr(lyr, f"{name}_u")
        with torch.no_grad():
            wm_ = _sn_reshape(worig._data, dim)
            u = ub._data
            for _ in range(max(1, int(n_power_iterations))):
                v = wm_.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wm_ @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            ub._data.copy_(u)
        object.__setattr__(lyr, name, _sn_divide(worig, u.clone(),
                                                 v.clone(), dim, eps))
        return inputs

    hook(layer, None)
    layer.register_forward_pre_hook(hook)
    return layer


@op("parameters_to_vector")
def _concat_flat(*arrs):
    return torch.cat([a.reshape(-1) for a in arrs])


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one 1-D Tensor."""
    return _concat_flat(*list(parameters))


def vector_to_parameters(vec, parameters, name=None):
    """Slice a flat vector back into the given parameters, in place."""
    data = vec._data if isinstance(vec, Tensor) else vec
    ofs = 0
    with torch.no_grad():
        for p in parameters:
            n = int(np.prod(p.shape))
            p._data.copy_(data[ofs:ofs + n].reshape(tuple(p.shape)))
            ofs += n
    if ofs != int(data.shape[0]):
        raise ValueError("vector length does not match total parameter size")
