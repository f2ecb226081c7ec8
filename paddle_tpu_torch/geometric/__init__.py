"""paddle.geometric: message passing, segment reductions and graph
sampling.

Port of paddle_tpu/geometric/__init__.py. Message passing
(`send_u_recv`, `send_ue_recv`, `send_uv`) and the segment reductions
are the reference's scatter / gather compositions, plain torch here
(`index_add`, `scatter_reduce`): ops of the Tensor API that
differentiate through torch autograd. A max or min reduction passes its
gradient as jnp's scatter-max does: to every message that ties for the
row's extreme, divided evenly among them (`_ScatterExtreme`). On the
card the float sums are atomic adds, whose order (and so the last bits
of a sum) may change from run to run. Rows that receive nothing are 0.

Graph restructuring (`reindex_graph`, `reindex_heter_graph`) and the
samplers have data-dependent output sizes and run on the host in numpy,
as the reference's do. The samplers draw from a numpy generator seeded
from the Tensor API's generator of the CPU (`core.rng`: `seed(n)`
repeats a draw); the reference seeds numpy from its jax key, so the two
packages' draws differ by design.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.device import device_of
from ..core.dispatch import op
from ..core.tensor import Tensor

__all__ = [
    'send_u_recv', 'send_ue_recv', 'send_uv',
    'segment_sum', 'segment_mean', 'segment_min', 'segment_max',
    'reindex_graph', 'reindex_heter_graph',
    'sample_neighbors', 'weighted_sample_neighbors',
]

_MSG_OPS = ("add", "sub", "mul", "div")
_REDUCE_OPS = ("sum", "mean", "max", "min")


class _ScatterExtreme(torch.autograd.Function):
    """Rows of the max (or min) of their messages; the gradient of a row
    goes to the messages that equal its extreme, split evenly among
    them (jnp's scatter-max rule)."""

    @staticmethod
    def forward(ctx, msg, dst, n_out, reduce):
        shape = (n_out,) + tuple(msg.shape[1:])
        idx = dst.reshape((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
        out = msg.new_zeros(shape).scatter_reduce(0, idx, msg, reduce,
                                                  include_self=False)
        hit = (msg == out.index_select(0, dst)).to(msg.dtype)
        count = torch.zeros_like(out).index_add(0, dst, hit)
        ctx.save_for_backward(dst, hit / count.index_select(0, dst))
        return out

    @staticmethod
    def backward(ctx, g):
        dst, share = ctx.saved_tensors
        return g.index_select(0, dst) * share, None, None, None


def _segment_reduce(msg, dst, n_out, reduce_op):
    """Reduce the messages [E, ...] onto [n_out, ...] rows by `dst`; rows
    that receive nothing are 0."""
    shape = (n_out,) + tuple(msg.shape[1:])
    if reduce_op == "sum":
        return msg.new_zeros(shape).index_add(0, dst, msg)
    if reduce_op == "mean":
        # jnp's true division: an integer sum divides as float64 when it
        # is int64, else as float32
        ft = msg.dtype if msg.is_floating_point() or msg.is_complex() \
            else torch.float64 if msg.dtype == torch.int64 else torch.float32
        tot = msg.new_zeros(shape).index_add(0, dst, msg).to(ft)
        cnt = torch.zeros(n_out, dtype=ft, device=msg.device).index_add(
            0, dst, torch.ones(dst.shape[0], dtype=ft, device=msg.device))
        return tot / cnt.clamp_min(1).reshape((n_out,) + (1,)
                                              * (msg.dim() - 1))
    if reduce_op not in ("max", "min"):
        raise ValueError(
            f"reduce_op should be one of {_REDUCE_OPS}, got {reduce_op}")
    return _ScatterExtreme.apply(msg, dst, n_out,
                                 "amax" if reduce_op == "max" else "amin")


def _resolve_out_size(out_size, x):
    """Output rows: out_size if given (> 0), else x's rows."""
    if out_size is not None:
        n = int(out_size.item()) if hasattr(out_size, "item") \
            else int(out_size)
        if n > 0:
            return n
    return x.shape[0]


def _message(u, v, message_op):
    if message_op == "add":
        return u + v
    if message_op == "sub":
        return u - v
    if message_op == "mul":
        return u * v
    return u / v


def _check(message_op=None, reduce_op=None):
    if message_op is not None and message_op not in _MSG_OPS:
        raise ValueError(
            f"message_op should be one of {_MSG_OPS}, got {message_op}")
    if reduce_op is not None and reduce_op not in _REDUCE_OPS:
        raise ValueError(
            f"reduce_op should be one of {_REDUCE_OPS}, got {reduce_op}")


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather x's rows at src_index, reduce them onto dst_index."""
    _check(reduce_op=reduce_op)
    return _send_u_recv(x, src_index, dst_index, reduce_op,
                        _resolve_out_size(out_size, x))


@op("send_u_recv")
def _send_u_recv(x, src, dst, reduce_op, n_out):
    return _segment_reduce(x[src.long()], dst.long(), n_out, reduce_op)


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Message x[src] (message_op) y (one row of y per edge), reduced
    onto dst_index."""
    _check(message_op, reduce_op)
    return _send_ue_recv(x, y, src_index, dst_index, message_op, reduce_op,
                         _resolve_out_size(out_size, x))


@op("send_ue_recv")
def _send_ue_recv(x, y, src, dst, message_op, reduce_op, n_out):
    return _segment_reduce(_message(x[src.long()], y, message_op),
                           dst.long(), n_out, reduce_op)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """The message x[src] (message_op) y[dst] of every edge."""
    _check(message_op)
    return _send_uv(x, y, src_index, dst_index, message_op)


@op("send_uv")
def _send_uv(x, y, src, dst, message_op):
    return _message(x[src.long()], y[dst.long()], message_op)


def _segment(data, segment_ids, pool):
    """Segment pooling over rows: max(segment_ids) + 1 segments, read on
    the host (segment ids are known before the op, as the reference's)."""
    ids = segment_ids._data if isinstance(segment_ids, Tensor) \
        else torch.as_tensor(segment_ids)
    n_seg = int(ids.max().item()) + 1 if ids.shape[0] else 0
    return _SEGMENT[pool](data, segment_ids, n_seg)


def _segment_op(pool):
    @op(f"segment_{pool}")
    def body(data, segment_ids, n_seg):
        return _segment_reduce(data, segment_ids.long(), n_seg, pool)

    return body


_SEGMENT = {p: _segment_op(p) for p in _REDUCE_OPS}


def segment_sum(data, segment_ids, name=None):
    return _segment(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    return _segment(data, segment_ids, "mean")


def segment_max(data, segment_ids, name=None):
    return _segment(data, segment_ids, "max")


def segment_min(data, segment_ids, name=None):
    return _segment(data, segment_ids, "min")


# ------------------------------------------------ host-side restructuring
def _np(t):
    if isinstance(t, Tensor):
        return t.numpy()
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _mk(a):
    """An int64 Tensor of `a` on the current device."""
    return Tensor._wrap(torch.as_tensor(np.asarray(a, np.int64),
                                        device=device_of(None)))


def _host_rng():
    """A numpy generator seeded from the Tensor API's CPU generator, so a
    draw repeats under `seed(n)` and each call advances the state."""
    words = torch.randint(0, 2 ** 31, (4,), dtype=torch.int64,
                          generator=rng.generator("cpu"))
    return np.random.default_rng(words.tolist())


def _first_seen(xs, nbr_lists):
    """(id -> local index, out_nodes): x's ids first, then the
    neighbours in first-seen order."""
    id2local = {int(v): i for i, v in enumerate(xs)}
    out_nodes = list(map(int, xs))
    for nbr in nbr_lists:
        for v in nbr:
            v = int(v)
            if v not in id2local:
                id2local[v] = len(out_nodes)
                out_nodes.append(v)
    return id2local, out_nodes


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Renumber a sampled subgraph to local ids: (reindex_src,
    reindex_dst, out_nodes), x's ids first, then the neighbours in
    first-seen order."""
    xs, nbr, cnt = _np(x), _np(neighbors), _np(count)
    id2local, out_nodes = _first_seen(xs, [nbr])
    src = [id2local[int(v)] for v in nbr]
    dst = np.repeat(np.arange(len(xs), dtype=np.int64), cnt)
    return _mk(src), _mk(dst), _mk(out_nodes)


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """The heterogeneous form: one neighbour and count list per edge type,
    one id space over x and every list in first-seen order."""
    xs = _np(x)
    nbrs = [_np(n) for n in neighbors]
    cnts = [_np(c) for c in count]
    id2local, out_nodes = _first_seen(xs, nbrs)
    src = [id2local[int(v)] for nbr in nbrs for v in nbr]
    dst = np.concatenate([np.repeat(np.arange(len(xs), dtype=np.int64), c)
                          for c in cnts]) if cnts else np.empty(0, np.int64)
    return _mk(src), _mk(dst), _mk(out_nodes)


def _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
            weights=None):
    r, cp, nodes = _np(row), _np(colptr), _np(input_nodes)
    gen = _host_rng()
    eid_arr = _np(eids) if eids is not None else None
    out_nbr, out_cnt, out_eid = [], [], []
    for v in nodes:
        beg, end = int(cp[int(v)]), int(cp[int(v) + 1])
        deg = end - beg
        if sample_size < 0 or deg <= sample_size:
            pick = np.arange(beg, end)
        elif weights is None:
            pick = beg + gen.choice(deg, size=sample_size, replace=False)
        else:
            p = weights[beg:end].astype(np.float64)
            total = p.sum()
            if total <= 0:
                raise ValueError(
                    f"weighted_sample_neighbors: node {int(v)} has {deg} "
                    f"candidate edges but non-positive total weight "
                    f"({total}); edge weights must be positive to sample")
            pick = beg + gen.choice(deg, size=sample_size, replace=False,
                                    p=p / total)
        out_nbr.append(r[pick])
        out_cnt.append(len(pick))
        if return_eids and eid_arr is not None:
            out_eid.append(eid_arr[pick])
    nbrs = _mk(np.concatenate(out_nbr) if out_nbr else [])
    cnts = _mk(out_cnt)
    if return_eids:
        return nbrs, cnts, _mk(np.concatenate(out_eid) if out_eid else [])
    return nbrs, cnts


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbour sampling without replacement on a CSC graph:
    (neighbours, counts[, edge ids]); every neighbour of a node with at
    most `sample_size` of them (or all, at -1)."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """Neighbour sampling without replacement, each edge drawn in
    proportion to its weight."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
                   weights=_np(edge_weight))
