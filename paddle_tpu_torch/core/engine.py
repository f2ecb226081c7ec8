"""Backward and `grad` on torch autograd.

Port of paddle_tpu/core/engine.py `run_backward` (:170) and `grad`
(:322). The reference walks its own GradNodes; the port hands the root to
`torch.autograd` and keeps the reference's rules around it: a
`stop_gradient` root raises, a non-scalar root needs `grad_tensor`, a
second backward without `retain_graph` raises (torch's RuntimeError),
`create_graph` records the backward for another one (double grad), and
`restrict_to` (`grad`'s semantics) lets only the listed inputs receive
gradients: `grad` returns them and leaves every `.grad` untouched.
"""
from __future__ import annotations

import torch

from .tensor import Tensor, _raw


def _seed(root: Tensor, grad_tensor):
    d = root._data
    if grad_tensor is None:
        if d.numel() != 1:
            raise RuntimeError(
                "grad must be provided for non-scalar backward root "
                f"(shape {root.shape})")
        return torch.ones_like(d)
    g = _raw(grad_tensor)
    if not isinstance(g, torch.Tensor):
        g = torch.as_tensor(g)
    return g.to(device=d.device, dtype=d.dtype).broadcast_to(d.shape)


def _check_root(root: Tensor):
    if root.stop_gradient:
        raise RuntimeError("Tensor.backward() on a tensor with "
                           "stop_gradient=True — nothing to do")


def run_backward(root: Tensor, grad_tensor=None, retain_graph=False,
                 create_graph=False, restrict_to=None):
    """Accumulate d root / d leaf into every reachable leaf's `.grad` (and
    into the retained intermediates'); `restrict_to`: the only tensors
    (Tensors) that may receive gradients."""
    _check_root(root)
    seed = _seed(root, grad_tensor)
    inputs = None if restrict_to is None else [t._data for t in restrict_to]
    torch.autograd.backward(root._data, seed, retain_graph=retain_graph,
                            create_graph=create_graph, inputs=inputs)


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False):
    """paddle.grad: d outputs / d inputs, without touching any `.grad`.
    create_graph=True records the backward (implies retain_graph), so the
    returned gradients can be differentiated again."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    for o in outputs:
        _check_root(o)
    seeds = [_seed(o, g) for o, g in zip(outputs, grad_outputs)]
    gs = torch.autograd.grad(
        [o._data for o in outputs], [t._data for t in inputs], seeds,
        retain_graph=bool(retain_graph or create_graph),
        create_graph=create_graph, allow_unused=True)
    result = []
    for t, g in zip(inputs, gs):
        if g is None and not allow_unused:
            raise RuntimeError(f"input {t.name} unused in graph "
                               "(allow_unused=False)")
        result.append(None if g is None else Tensor._wrap(g))
    return result
