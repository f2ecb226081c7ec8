"""paddle.incubate: experimental APIs.

Port of paddle_tpu/incubate/__init__.py: `identity_loss`, the masked
softmaxes, the optimizer wrappers `LookAhead` and `ModelAverage`,
`graph_khop_sampler` and the `graph_*` / `segment_*` aliases of
`geometric`, with `autograd` (jvp, vjp, Jacobian, Hessian) and `nn`
(the fused-op functional API). The reference's fused CUDA softmaxes are
XLA compositions there, plain torch here.

`LookAhead` and `ModelAverage` keep their slow or summed weights and
their step counters on the parameters' device and decide on the device
(`torch.where`), so a step that calls them captures under `to_static`
and replays right: no host branch on a count.
"""
import contextlib as _contextlib

import numpy as _np
import torch as _torch

from . import autograd, distributed, nn  # noqa: F401
from .. import inference  # noqa: F401
from ..core.dispatch import op as _op
from ..core.tensor import Tensor as _Tensor
from ..geometric import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_sum)
from ..geometric import (  # noqa: F401
    reindex_graph as graph_reindex, sample_neighbors as graph_sample_neighbors,
    send_u_recv as graph_send_recv)

__all__ = [
    "autograd", "distributed", "nn",
    "segment_max", "segment_mean", "segment_min", "segment_sum",
    "graph_reindex", "graph_sample_neighbors", "graph_send_recv",
    "graph_khop_sampler", "identity_loss", "inference",
    "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
    "LookAhead", "ModelAverage",
]


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbour sampling: `sample_neighbors` over each hop,
    hop k expanding only the nodes hop k - 1 found first. Returns
    (edge sources, edge destinations, every node seen, the counts of each
    hop). `return_eids` raises, as the reference's does (the host sampler
    does not track edge ids)."""
    from ..geometric import _mk, _np as _host, sample_neighbors

    if return_eids:
        raise NotImplementedError(
            "graph_khop_sampler(return_eids=True) is not supported: the "
            "host sampler does not track edge ids — use "
            "geometric.sample_neighbors(..., eids=..., return_eids=True) "
            "per hop")
    frontier = input_nodes
    seen = _np.unique(_host(input_nodes))
    srcs, dsts, counts = [], [], []
    for k in sample_sizes:
        nbrs, cnt = sample_neighbors(row, colptr, frontier, sample_size=k)
        srcs.append(_host(nbrs))
        dsts.append(_np.repeat(_host(frontier), _host(cnt)))
        counts.append(cnt)
        fresh = _np.setdiff1d(_host(nbrs), seen)
        seen = _np.union1d(seen, fresh)
        frontier = _mk(fresh)
    return (_mk(_np.concatenate(srcs)), _mk(_np.concatenate(dsts)),
            _mk(seen), counts)


def identity_loss(x, reduction="none"):
    """The reduction `reduction` of x ("sum" / 0, "mean" / 1), else x
    itself (the reference marks a loss for IPU graphs this way)."""
    from ..ops.reduction import mean as _mean, sum as _sum

    if reduction in (0, "sum"):
        return _sum(x)
    if reduction in (1, "mean"):
        return _mean(x)
    return x


@_op("softmax_mask_fuse")
def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis."""
    return _torch.softmax(x + mask, dim=-1)


@_op("softmax_mask_fuse_upper_triangle")
def softmax_mask_fuse_upper_triangle(x, name=None):
    """The causal softmax: each row over the columns up to its own."""
    keep = _torch.ones(x.shape[-2], x.shape[-1], dtype=_torch.bool,
                       device=x.device).tril()
    return _torch.softmax(x.masked_fill(~keep, float("-inf")), dim=-1)


def _leaves(params):
    return [p._data if isinstance(p, _Tensor) else p for p in params]


class LookAhead:
    """Wraps an optimizer: every `k`-th step moves the slow weights
    `alpha` of the way to the fast ones and sets the fast weights to
    them; the slow weights start as the fast ones after the first step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = None
        self._step_t = None

    @_torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        params = _leaves(self.inner_optimizer._parameters)
        if self._slow is None:
            self._slow = [p.detach().clone() for p in params]
            self._step_t = _torch.zeros((), dtype=_torch.int64,
                                        device=params[0].device)
        self._step_t.add_(1)
        first = self._step_t == 1
        sync = _torch.remainder(self._step_t, self.k) == 0
        for p, slow in zip(params, self._slow):
            s = _torch.where(first, p, slow)
            s = _torch.where(sync, s + self.alpha * (p - s), s)
            slow.copy_(s)
            p.copy_(_torch.where(sync, s.to(p.dtype), p))

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def state_dict(self):
        return self.inner_optimizer.state_dict()

    def set_state_dict(self, state):
        self.inner_optimizer.set_state_dict(state)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, None


class ModelAverage:
    """The running mean of parameters over a sliding window (its length
    `average_window_rate` times the updates so far, held within
    [min_average_window, max_average_window]); `apply()` swaps the means
    in (and `restore()` the weights back)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._params = list(parameters or [])
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._sum = None
        self._count = self._total = None
        self._backup = {}

    @_torch.no_grad()
    def step(self):
        params = _leaves(self._params)
        if self._sum is None:
            dev = params[0].device
            self._sum = [_torch.zeros_like(p, dtype=_torch.float32)
                         if p.is_floating_point() else _torch.zeros_like(p)
                         for p in params]
            self._count = _torch.zeros((), dtype=_torch.float64, device=dev)
            self._total = _torch.zeros((), dtype=_torch.float64, device=dev)
        self._total.add_(1)
        window = _torch.clamp(_torch.floor(self._total * self._rate),
                              min=self._min_w, max=self._max_w).clamp_min(1)
        self._count.add_(1)
        over = self._count > window
        scale = _torch.where(over, window / self._count, 1.0)
        for acc, p in zip(self._sum, params):
            acc.copy_((acc + p) * scale.to(acc.dtype))
        self._count.copy_(_torch.where(over, window, self._count))

    @_contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        with _torch.no_grad():
            for i, (p, d) in enumerate(zip(self._params,
                                           _leaves(self._params))):
                self._backup[id(p)] = d.detach().clone()
                if self._sum is not None:
                    d.copy_((self._sum[i] / self._count).to(d.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @_torch.no_grad()
    def restore(self, executor=None):
        for p, d in zip(self._params, _leaves(self._params)):
            if id(p) in self._backup:
                d.copy_(self._backup.pop(id(p)))

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, None
