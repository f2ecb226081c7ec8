"""Gradient clipping: `ClipGradByValue`, `ClipGradByNorm`,
`ClipGradByGlobalNorm`, `clip_grad_norm_`, `clip_grad_value_`.

Port of paddle_tpu/nn/clip.py. The classes take a list of (param, grad)
pairs and return the clipped list, as the optimizers apply them before
their update (`grad_clip=`); a None gradient passes through. Norms are
sums of f32 squares (f64 for f64 gradients), then a square root, and the
scale is min(clip / max(norm, 1e-12), 1), kept on the gradients' device
(no read back to the host); g * scale is computed in f32 and rounded to
g's dtype. The reference's clipping is an XLA composition, so this is
plain torch: the global norm reads each gradient once
(`torch._foreach_norm`), adding the per-tensor norms' squares.
"""
from __future__ import annotations

import torch

from ..ops.fused_optimizer import _scaled


def _clip_scale(norm, clip_norm):
    """min(clip / max(norm, 1e-12), 1) as a 0-dim tensor beside `norm`."""
    return torch.clamp(torch.full_like(norm, clip_norm)
                       / torch.clamp(norm, min=1e-12), max=1.0)


def _norms(grads):
    """Each gradient's 2-norm, accumulated in f32 (f64 for f64)."""
    out = []
    for dt in dict.fromkeys(g.dtype for g in grads):
        acc = torch.float64 if dt == torch.float64 else torch.float32
        out += torch._foreach_norm([g for g in grads if g.dtype == dt], 2.0,
                                   dtype=acc)
    return out


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into [min, max] (min = -max by
    default)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        with torch.no_grad():
            return [(p, g if g is None else torch.clamp(g, self.min,
                                                        self.max))
                    for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own to a 2-norm of at most
    `clip_norm`."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        with torch.no_grad():
            out = []
            for p, g in params_grads:
                if g is not None:
                    g = _scaled(g, _clip_scale(_norms([g])[0],
                                               self.clip_norm))
                out.append((p, g))
            return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by one factor, so that their joint 2-norm is
    at most `clip_norm`. The optimizers' fused path reads `scale` on the
    card instead of a clipped copy of each gradient."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def scale(self, grads):
        """The f32 factor (a 0-dim tensor on the gradients' device) for the
        non-None gradients `grads`."""
        with torch.no_grad():
            norms = _norms(grads)
            if len({n.dtype for n in norms}) > 1:
                norms = [n.double() for n in norms]
            sq = torch.stack(norms).square().sum()
            return _clip_scale(sq.sqrt().float(), self.clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        s = self.scale(grads)
        with torch.no_grad():
            return [(p, g if g is None else _scaled(g, s))
                    for p, g in params_grads]


def _grad_params(parameters):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    return [p for p in params if p.grad is not None]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place so that their joint
    `norm_type`-norm (f32) is at most `max_norm`; returns that norm."""
    params = _grad_params(parameters)
    if not params:
        return torch.zeros(())
    with torch.no_grad():
        grads = [p.grad for p in params]
        if norm_type == float("inf"):
            total = torch.stack([g.abs().max().float() for g in grads]).max()
        else:
            total = sum(g.float().abs().pow(norm_type).sum()
                        for g in grads) ** (1.0 / norm_type)
        if error_if_nonfinite and not bool(torch.isfinite(total)):
            raise RuntimeError(
                "The total norm of gradients is non-finite, so it cannot "
                "be clipped (clip_grad_norm_ error_if_nonfinite=True)")
        s = _clip_scale(total, max_norm)
        for g in grads:
            g.copy_(_scaled(g, s))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the parameters' gradients into [-clip_value, clip_value] in
    place."""
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)
