"""The port's copy of paddle_tpu/ops/op_table_ext.py's rows that this
package ports (see `op_table`); `ensure_populated` pulls it.
"""
from __future__ import annotations

import math as _math

import numpy as np

from .op_table import OpSpec, register

_POS = (0.2, 2.0)
_UNIT = (-0.95, 0.95)
_SAFE = (-2.0, 2.0)


def _np_softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def populate_ext():
    import paddle_tpu_torch as pd

    from . import extras as ex
    from . import linalg as la
    from . import manipulation as mp
    from . import math as m
    from . import reduction as r

    # ---- special functions (vs scipy-free numpy refs where stable)
    register(OpSpec("gammaln", ex.gammaln, 1, True, domain=_POS,
                    ref=np.vectorize(_math.lgamma), tags=("special",)))
    register(OpSpec("gammainc", ex.gammainc, 2, True,
                    domains=(_POS, _POS), tags=("special",)))
    register(OpSpec("gammaincc", ex.gammaincc, 2, True,
                    domains=(_POS, _POS), tags=("special",)))
    register(OpSpec("multigammaln", lambda x: ex.multigammaln(x, 2), 1, True,
                    domain=(1.5, 3.0), tags=("special",)))
    register(OpSpec("polygamma", lambda x: ex.polygamma(x, 1), 1, True,
                    domain=_POS, tags=("special",)))
    register(OpSpec("i0e", ex.i0e, 1, True, tags=("special",)))
    register(OpSpec("i1", ex.i1, 1, True, tags=("special",)))
    register(OpSpec("i1e", ex.i1e, 1, True, tags=("special",)))
    register(OpSpec("sinc", ex.sinc, 1, True, ref=np.sinc,
                    tags=("special",)))
    register(OpSpec("sgn", ex.sgn, 1, False, ref=np.sign, tags=("special",)))
    register(OpSpec("logit", m.logit, 1, True, domain=(0.05, 0.95),
                    ref=lambda x: np.log(x / (1 - x)), tags=("special",)))
    register(OpSpec("expit_via_sigmoid", m.sigmoid, 1, True,
                    ref=lambda x: 1 / (1 + np.exp(-x)), tags=("special",)))
    register(OpSpec("square_grad", m.square, 1, True, ref=np.square,
                    tags=("special",)))
    register(OpSpec("stanh", m.stanh, 1, True,
                    ref=lambda x: 1.7159 * np.tanh(0.67 * x),
                    rtol=1e-4, tags=("special",)))

    # ---- comparison / predicate tails
    register(OpSpec("allclose", lambda a, b: pd.allclose(a, b), 2, False,
                    ref=lambda a, b: np.allclose(a, b), bf16=False,
                    tags=("logical",)))
    register(OpSpec("isclose", lambda a, b: pd.isclose(a, b), 2, False,
                    ref=np.isclose, bf16=False, tags=("logical",)))
    register(OpSpec("isneginf", ex.isneginf, 1, False, ref=np.isneginf,
                    bf16=False, tags=("logical",)))
    register(OpSpec("isposinf", ex.isposinf, 1, False, ref=np.isposinf,
                    bf16=False, tags=("logical",)))
    register(OpSpec("isreal", ex.isreal, 1, False, ref=np.isreal,
                    bf16=False, tags=("logical",)))
    register(OpSpec("is_empty", ex.is_empty, 1, False, bf16=False,
                    tags=("logical",)))
    register(OpSpec("isin_op", lambda a, b: ex.isin(a, b), 2, False,
                    ref=np.isin, bf16=False, int_inputs=(0, 1),
                    tags=("logical",)))

    # ---- math tails
    register(OpSpec("remainder", m.remainder if hasattr(m, "remainder")
                    else m.mod, 2, False,
                    domains=(_SAFE, _POS), ref=np.mod, tags=("binary",)))
    register(OpSpec("fmod", pd.fmod if hasattr(pd, "fmod") else
                    (lambda a, b: a - b * (a / b).trunc()), 2, False,
                    domains=(_SAFE, _POS), ref=np.fmod, tags=("binary",)))
    register(OpSpec("inner", pd.inner, 2, True, shapes=((3, 4), (2, 4)),
                    ref=np.inner, tags=("linalg",)))
    register(OpSpec("logaddexp2_via_log2", m.log2, 1, True, domain=_POS,
                    ref=np.log2, tags=("unary",)))
    register(OpSpec("rsqrt_grad", m.rsqrt, 1, True, domain=_POS,
                    ref=lambda x: 1 / np.sqrt(x), tags=("unary",)))
    register(OpSpec("trapezoid", ex.trapezoid, 1, True, shape=(3, 5),
                    ref=lambda y: np.trapezoid(y, axis=-1),
                    tags=("reduction",)))
    register(OpSpec("cumulative_trapezoid", ex.cumulative_trapezoid, 1,
                    True, shape=(3, 5), tags=("reduction",)))
    register(OpSpec("diff_op", ex.diff, 1, True, shape=(3, 5),
                    ref=lambda x: np.diff(x, axis=-1),
                    tags=("manipulation",)))
    register(OpSpec("frac_op", m.frac, 1, False,
                    ref=lambda x: x - np.trunc(x), tags=("unary",)))
    register(OpSpec("nan_to_num", lambda x: pd.nan_to_num(x), 1, True,
                    ref=np.nan_to_num, tags=("unary",)))
    register(OpSpec("lerp_op", lambda a, b: m.lerp(a, b, 0.3), 2, True,
                    ref=lambda a, b: a + 0.3 * (b - a), tags=("binary",)))
    # bf16: torch has no bf16 angle kernel on the card; `ops.math` takes
    # it in f32 and casts back
    register(OpSpec("angle", pd.angle, 1, True, domain=_POS,
                    ref=lambda x: np.angle(x), tags=("unary",)))
    register(OpSpec("conj", pd.conj, 1, True, ref=np.conj, tags=("unary",)))
    register(OpSpec("real", pd.real, 1, True, ref=np.real, tags=("unary",)))
    register(OpSpec("scale_op",
                    lambda x: m.scale(x, scale=2.0, bias=1.0), 1, True,
                    ref=lambda x: 2 * x + 1, tags=("unary",)))
    register(OpSpec("clip_grad", lambda x: m.clip(x, -1.0, 1.0), 1, True,
                    ref=lambda x: np.clip(x, -1, 1), tags=("unary",)))
    register(OpSpec("logcumsumexp", lambda x: m.logcumsumexp(x, axis=0), 1,
                    True, shape=(4, 3),
                    ref=lambda x: np.log(np.cumsum(np.exp(x), 0)),
                    rtol=1e-4, tags=("reduction",)))
    register(OpSpec("logdet_via_slogdet",
                    lambda x: la.slogdet(x)[1], 1, True, shape=(3, 3),
                    domain=(0.5, 1.5),
                    bf16=False,
                    tags=("linalg",)))

    # ---- reductions tails
    register(OpSpec("count_nonzero", lambda x: pd.count_nonzero(x), 1,
                    False, ref=np.count_nonzero, bf16=False,
                    tags=("reduction",)))
    register(OpSpec("nanmedian", r.nanmedian, 1, False, ref=np.nanmedian,
                    tags=("reduction",)))
    register(OpSpec("quantile", lambda x: r.quantile(x, 0.5), 1, True,
                    ref=lambda x: np.quantile(x, 0.5), tags=("reduction",)))
    register(OpSpec("nanquantile", lambda x: r.nanquantile(x, 0.5), 1,
                    False, ref=lambda x: np.nanquantile(x, 0.5),
                    tags=("reduction",)))
    register(OpSpec("cummax", lambda x: pd.cummax(x, axis=0)[0], 1, True,
                    shape=(4, 3), ref=lambda x: np.maximum.accumulate(x, 0),
                    tags=("reduction",)))
    register(OpSpec("cummin", lambda x: pd.cummin(x, axis=0)[0], 1, True,
                    shape=(4, 3), ref=lambda x: np.minimum.accumulate(x, 0),
                    tags=("reduction",)))
    register(OpSpec("mode", lambda x: pd.mode(x)[0], 1, False, shape=(3, 5),
                    int_inputs=(0,), bf16=False, tags=("reduction",)))
    register(OpSpec("median_min",
                    lambda x: r.median(x, axis=-1, mode="min")[0], 1, False,
                    shape=(3, 5), tags=("reduction",)))
    register(OpSpec("reduce_as", ex.reduce_as, 2, True,
                    shapes=((4, 3), (1, 3)),
                    ref=lambda x, t: x.sum(0, keepdims=True),
                    no_grad_inputs=(1,), tags=("reduction",)))
    register(OpSpec("norm_p1", lambda x: la.norm(x, p=1), 1, True,
                    ref=lambda x: np.abs(x).sum(), tags=("reduction",)))
    register(OpSpec("norm_inf",
                    lambda x: la.norm(x, p=float("inf")), 1, True,
                    ref=lambda x: np.abs(x).max(), tags=("reduction",)))
    register(OpSpec("dist", lambda a, b: pd.dist(a, b, p=2), 2, True,
                    ref=lambda a, b: np.linalg.norm((a - b).ravel()),
                    tags=("reduction",)))

    # ---- manipulation tails
    register(OpSpec("unstack_op", lambda x: ex.unstack(x, 0)[0], 1, True,
                    shape=(3, 4), ref=lambda x: x[0], tags=("manipulation",)))
    register(OpSpec("unflatten_op", lambda x: ex.unflatten(x, 0, [2, 2]), 1,
                    True, shape=(4, 3),
                    ref=lambda x: x.reshape(2, 2, 3), tags=("manipulation",)))
    register(OpSpec("unbind", lambda x: pd.unbind(x, 0)[1], 1, True,
                    shape=(3, 4), ref=lambda x: x[1], tags=("manipulation",)))
    register(OpSpec("rot90", lambda x: pd.rot90(x), 1, True, shape=(3, 4),
                    ref=lambda x: np.rot90(x), tags=("manipulation",)))
    register(OpSpec("moveaxis", lambda x: pd.moveaxis(x, 0, 1), 1, True,
                    ref=lambda x: np.moveaxis(x, 0, 1),
                    tags=("manipulation",)))
    register(OpSpec("swapaxes", lambda x: pd.swapaxes(x, 0, 1), 1, True,
                    ref=lambda x: np.swapaxes(x, 0, 1),
                    tags=("manipulation",)))
    register(OpSpec("expand_as", lambda x, y: pd.expand_as(x, y), 2, True,
                    shapes=((1, 3), (4, 3)),
                    ref=lambda x, y: np.broadcast_to(x, y.shape),
                    no_grad_inputs=(1,), tags=("manipulation",)))
    register(OpSpec("as_strided",
                    lambda x: pd.as_strided(x, [2, 2], [1, 1]), 1, True,
                    shape=(6,), tags=("manipulation",)))
    register(OpSpec("view_op", lambda x: pd.view(x, [3, 2]), 1, True,
                    shape=(2, 3), ref=lambda x: x.reshape(3, 2),
                    tags=("manipulation",)))
    register(OpSpec("atleast_2d", lambda x: pd.atleast_2d(x), 1, True,
                    shape=(4,), ref=np.atleast_2d, tags=("manipulation",)))
    register(OpSpec("atleast_3d", lambda x: pd.atleast_3d(x), 1, True,
                    shape=(4,), ref=np.atleast_3d, tags=("manipulation",)))
    register(OpSpec("hstack", lambda a, b: pd.hstack([a, b]), 2, True,
                    ref=lambda a, b: np.hstack([a, b]),
                    tags=("manipulation",)))
    register(OpSpec("vstack", lambda a, b: pd.vstack([a, b]), 2, True,
                    ref=lambda a, b: np.vstack([a, b]),
                    tags=("manipulation",)))
    register(OpSpec("dstack", lambda a, b: pd.dstack([a, b]), 2, True,
                    ref=lambda a, b: np.dstack([a, b]),
                    tags=("manipulation",)))
    register(OpSpec("column_stack", lambda a, b: pd.column_stack([a, b]), 2,
                    True, ref=lambda a, b: np.column_stack([a, b]),
                    tags=("manipulation",)))
    register(OpSpec("row_stack", lambda a, b: pd.row_stack([a, b]), 2, True,
                    ref=lambda a, b: np.vstack([a, b]),
                    tags=("manipulation",)))
    register(OpSpec("hsplit", lambda x: pd.hsplit(x, 2)[0], 1, True,
                    shape=(3, 4), ref=lambda x: np.hsplit(x, 2)[0],
                    tags=("manipulation",)))
    register(OpSpec("vsplit", lambda x: pd.vsplit(x, 2)[0], 1, True,
                    shape=(4, 3), ref=lambda x: np.vsplit(x, 2)[0],
                    tags=("manipulation",)))
    register(OpSpec("tensor_split",
                    lambda x: pd.tensor_split(x, 2, axis=0)[0], 1, True,
                    shape=(4, 3),
                    ref=lambda x: np.array_split(x, 2, axis=0)[0],
                    tags=("manipulation",)))
    register(OpSpec("crop", lambda x: pd.crop(x, shape=[2, 2],
                                              offsets=[1, 1]), 1, True,
                    shape=(4, 4), ref=lambda x: x[1:3, 1:3],
                    tags=("manipulation",)))
    register(OpSpec("slice_op",
                    lambda x: pd.slice(x, [0], [1], [3]), 1, True,
                    shape=(4, 3), ref=lambda x: x[1:3],
                    tags=("manipulation",)))
    register(OpSpec("strided_slice",
                    lambda x: pd.strided_slice(x, [0], [0], [4], [2]), 1,
                    True, shape=(4, 3), ref=lambda x: x[0:4:2],
                    tags=("manipulation",)))
    register(OpSpec("index_put",
                    lambda x, i, v: pd.index_put(x, [i], v), 3, True,
                    shapes=((4, 3), (2,), (2, 3)), int_inputs=(1,),
                    int_high=4, tags=("manipulation",)))
    register(OpSpec("index_fill",
                    lambda x, i: pd.index_fill(x, i, 0, 0.5), 2, True,
                    shapes=((4, 3), (2,)), int_inputs=(1,), int_high=4,
                    tags=("manipulation",)))
    register(OpSpec("index_add",
                    lambda x, i, v: pd.index_add(x, i, 0, v), 3, True,
                    shapes=((4, 3), (2,), (2, 3)), int_inputs=(1,),
                    int_high=4, tags=("manipulation",)))
    register(OpSpec("put_along_axis",
                    lambda x, i, v: mp.put_along_axis(x, i, v, 1), 3, True,
                    shapes=((3, 4), (3, 2), (3, 2)), int_inputs=(1,),
                    int_high=4, tags=("manipulation",)))
    register(OpSpec("scatter_op", lambda x, i, u: mp.scatter(x, i, u), 3,
                    True, shapes=((4, 3), (2,), (2, 3)), int_inputs=(1,),
                    int_high=4, tags=("manipulation",)))
    register(OpSpec("scatter_nd_add",
                    lambda x, i, u: pd.scatter_nd_add(x, i, u), 3, True,
                    shapes=((4, 3), (2, 1), (2, 3)), int_inputs=(1,),
                    int_high=4, tags=("manipulation",)))
    register(OpSpec("gather_nd", lambda x, i: mp.gather_nd(x, i), 2, True,
                    shapes=((4, 3), (2, 2)), int_inputs=(1,), int_high=3,
                    tags=("manipulation",)))
    register(OpSpec("masked_select", lambda x, m2: pd.masked_select(
        x, m2 > 2), 2, False, int_inputs=(1,), bf16=False,
        ref=lambda x, m2: x[m2 > 2], tags=("manipulation",)))
    register(OpSpec("masked_scatter",
                    lambda x, m2, v: pd.masked_scatter(x, m2 > 2, v), 3,
                    False, int_inputs=(1,), bf16=False,
                    tags=("manipulation",)))
    register(OpSpec("select_scatter",
                    lambda x, v: pd.select_scatter(x, v, 0, 1), 2, True,
                    shapes=((3, 4), (4,)), tags=("manipulation",)))
    register(OpSpec("diagonal_scatter",
                    lambda x, v: pd.diagonal_scatter(x, v), 2, True,
                    shapes=((3, 3), (3,)), tags=("manipulation",)))
    register(OpSpec("fill_diagonal_tensor",
                    lambda x, v: ex.fill_diagonal_tensor(x, v), 2, True,
                    shapes=((3, 3), (3,)), no_grad_inputs=(1,), tags=("manipulation",)))
    register(OpSpec("roll_axis", lambda x: mp.roll(x, 1, axis=1), 1, True,
                    ref=lambda x: np.roll(x, 1, axis=1),
                    tags=("manipulation",)))
    register(OpSpec("rot90_k2", lambda x: pd.rot90(x, k=2), 1, True,
                    shape=(3, 4), ref=lambda x: np.rot90(x, 2),
                    tags=("manipulation",)))
    register(OpSpec("flatten_range",
                    lambda x: mp.flatten(x, start_axis=1, stop_axis=2), 1,
                    True, shape=(2, 3, 4),
                    ref=lambda x: x.reshape(2, 12), tags=("manipulation",)))
    register(OpSpec("repeat_tensor",
                    lambda x: pd.repeat_interleave(x, 3, axis=1), 1, True,
                    ref=lambda x: np.repeat(x, 3, axis=1),
                    tags=("manipulation",)))
    register(OpSpec("unique_vals", lambda x: mp.unique(x), 1, False,
                    int_inputs=(0,), bf16=False, ref=np.unique,
                    tags=("manipulation",)))
    register(OpSpec("unique_consecutive_vals",
                    lambda x: mp.unique_consecutive(x), 1, False,
                    int_inputs=(0,), bf16=False, tags=("manipulation",)))
    register(OpSpec("bucketize", lambda s, v: pd.bucketize(v, s), 2, False,
                    shapes=((4,), (3,)), domains=((0.0, 1.0), (0.0, 1.0)),
                    bf16=False, tags=("search",)))
    register(OpSpec("vander", lambda x: pd.vander(x, 3), 1, True,
                    shape=(4,), ref=lambda x: np.vander(x, 3),
                    tags=("creation",)))
    register(OpSpec("renorm", lambda x: pd.renorm(x, 2.0, 0, 1.0), 1, True,
                    shape=(3, 4), tags=("manipulation",)))
    register(OpSpec("flip_multi", lambda x: mp.flip(x, [0, 1]), 1, True,
                    ref=lambda x: np.flip(x, (0, 1)),
                    tags=("manipulation",)))
    register(OpSpec("shard_index_like_cast",
                    lambda x: x.astype("int32").astype("float32"), 1, False,
                    tags=("manipulation",)))

    # ---- linalg decompositions / solvers (forward parity; most n_diff via
    # tape where JAX defines gradients)
    spd = lambda x: x @ np.swapaxes(x, -1, -2) + 3 * np.eye(x.shape[-1],
                                                            dtype=x.dtype)

    register(OpSpec("inverse", la.inverse, 1, True, shape=(3, 3),
                    domain=(0.5, 1.5),
                    bf16=False,
                    tags=("linalg",)))
    register(OpSpec("det",
                    la.det, 1, True, shape=(3, 3), domain=(0.5, 1.5),
                    ref=np.linalg.det, rtol=1e-4, bf16=False,
                    tags=("linalg",)))
    register(OpSpec("slogdet", lambda x: la.slogdet(x)[1], 1, True,
                    shape=(3, 3), domain=(0.5, 1.5), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("cholesky",
                    lambda x: la.cholesky(pd.to_tensor(np.eye(3, dtype="float32") * 2.0) + x @ x.t() * 0.1),
                    1, True, shape=(3, 3), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("qr_q", lambda x: la.qr(x)[0], 1, True, shape=(3, 3),
                    bf16=False,
                    tags=("linalg",)))
    register(OpSpec("svdvals", lambda x: la.svd(x)[1], 1, True,
                    shape=(3, 3),
                    ref=lambda x: np.linalg.svd(x, compute_uv=False),
                    rtol=1e-4, bf16=False,
                    tags=("linalg",)))
    register(OpSpec("eigvalsh_op", lambda x: la.eigvalsh(x), 1, True,
                    shape=(3, 3), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("matrix_power", lambda x: la.matrix_power(x, 2), 1,
                    True, shape=(3, 3), ref=lambda x: x @ x,
                    bf16=False,
                    tags=("linalg",)))
    register(OpSpec("pinv", la.pinv, 1, True, shape=(3, 4),
                    ref=np.linalg.pinv, rtol=1e-3, atol=1e-4,
                    bf16=False,
                    tags=("linalg",)))
    register(OpSpec("solve", la.solve, 2, True, shapes=((3, 3), (3, 2)),
                    domains=((0.5, 1.5), _SAFE),
                    bf16=False,
                    tags=("linalg",)))
    register(OpSpec("triangular_solve",
                    lambda a, b: la.triangular_solve(a, b, upper=False), 2,
                    True, shapes=((3, 3), (3, 2)),
                    domains=((0.8, 1.5), _SAFE), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("matrix_rank_op", lambda x: la.matrix_rank(x), 1,
                    False, shape=(3, 3), ref=np.linalg.matrix_rank,
                    bf16=False, tags=("linalg",)))
    register(OpSpec("cond_2", lambda x: la.cond(x), 1, False,
                    shape=(3, 3), domain=(0.5, 1.5),
                    ref=lambda x: np.linalg.cond(x), rtol=1e-3,
                    bf16=False,
                    tags=("linalg",)))
    register(OpSpec("cov_op", lambda x: la.cov(x), 1, True, shape=(3, 6),
                    ref=lambda x: np.cov(x), rtol=1e-4, tags=("linalg",)))
    register(OpSpec("corrcoef_op", lambda x: la.corrcoef(x), 1, True,
                    shape=(3, 6), ref=np.corrcoef, rtol=1e-4,
                    tags=("linalg",)))
    register(OpSpec("householder_product",
                    lambda a, tau: la.householder_product(a, tau), 2, True,
                    shapes=((4, 3), (3,)), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("tensordot_op",
                    lambda a, b: pd.tensordot(a, b, axes=1), 2, True,
                    shapes=((3, 4), (4, 2)),
                    ref=lambda a, b: np.tensordot(a, b, 1),
                    tags=("linalg",)))
    register(OpSpec("multi_dot",
                    lambda a, b, c: la.multi_dot([a, b, c]), 3, True,
                    shapes=((2, 3), (3, 4), (4, 2)),
                    ref=lambda a, b, c: a @ b @ c, tags=("linalg",)))
    register(OpSpec("lu_op", lambda x: la.lu(x)[0], 1, False,
                    shape=(3, 3), domain=(0.5, 1.5), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("ormqr",
                    lambda a, tau, o: ex.ormqr(a, tau, o), 3, False,
                    shapes=((3, 3), (3,), (3, 2)), bf16=False,
                    tags=("linalg",)))
    register(OpSpec("cdist", lambda a, b: pd.cdist(a, b), 2, True,
                    shapes=((3, 4), (2, 4)), rtol=1e-4, tags=("linalg",)))
    register(OpSpec("bincount", lambda x: pd.bincount(x), 1, False,
                    shape=(6,), int_inputs=(0,), bf16=False,
                    ref=np.bincount, tags=("reduction",)))
    register(OpSpec("histogram",
                    lambda x: pd.histogram(x, bins=4, min=-2, max=2), 1,
                    False, bf16=False,
                    ref=lambda x: np.histogram(x, 4, (-2, 2))[0],
                    tags=("reduction",)))
    register(OpSpec("histogram_bin_edges",
                    lambda x: ex.histogram_bin_edges(x, 4, -2, 2), 1, False,
                    bf16=False,
                    ref=lambda x: np.histogram_bin_edges(x, 4, (-2, 2)),
                    tags=("reduction",)))

    # ---- nn.functional: convs / norms / embeddings (fwd + grad through
    # dispatched path; refs where a clean numpy form exists)
    register(OpSpec("affine_channel_op",
                    lambda x, s, b: ex.affine_channel(x, s, b), 3, True,
                    shapes=((1, 2, 3, 3), (2,), (2,)), tags=("nn",)))

    # ---- losses
    register(OpSpec("hinge_loss_op", lambda x, y: ex.hinge_loss(
        x, (m.sign(y) + 1) / 2), 2, True, no_grad_inputs=(1,), tags=("loss",)))

    # ---- search / sampling tails
    register(OpSpec("nonzero", lambda x: pd.nonzero(x > 0)[0] if isinstance(
        pd.nonzero(x > 0), (list, tuple)) else pd.nonzero(x > 0), 1, False,
        bf16=False, tags=("search",)))
    register(OpSpec("index_sample",
                    lambda x, i: pd.index_sample(x, i), 2, True,
                    shapes=((3, 4), (3, 2)), int_inputs=(1,), int_high=4,
                    ref=lambda x, i: np.take_along_axis(x, i, 1),
                    tags=("search",)))
    register(OpSpec("take", lambda x, i: pd.take(x, i), 2, True,
                    shapes=((3, 4), (3,)), int_inputs=(1,), int_high=10,
                    ref=lambda x, i: x.ravel()[i], tags=("search",)))
    register(OpSpec("searchsorted_right",
                    lambda s, v: pd.searchsorted(mp.sort(s), v, right=True),
                    2, False, shapes=((5,), (3,)),
                    domains=((0.0, 1.0), (0.0, 1.0)), bf16=False,
                    ref=lambda s, v: np.searchsorted(np.sort(s), v,
                                                     side="right"),
                    tags=("search",)))

    # ---- fft / signal (forward parity vs numpy)

    # ---- edit distance / sequence (forward-only, host-side)
    register(OpSpec("edit_distance_op",
                    lambda h, r2: ex.edit_distance(h, r2)[0], 2, False,
                    shapes=((2, 5), (2, 4)), int_inputs=(0, 1), int_high=4,
                    bf16=False, tags=("sequence",)))

    # ---- keepdim / axis variants (distinct compiled shapes)
    register(OpSpec("sum_axis_keepdim",
                    lambda x: r.sum(x, axis=1, keepdim=True), 1, True,
                    shape=(3, 4), ref=lambda x: x.sum(1, keepdims=True),
                    tags=("reduction",)))
    register(OpSpec("mean_axis", lambda x: r.mean(x, axis=0), 1, True,
                    shape=(3, 4), ref=lambda x: x.mean(0),
                    tags=("reduction",)))
    register(OpSpec("max_axis", lambda x: r.max(x, axis=1), 1, True,
                    shape=(3, 4), ref=lambda x: x.max(1),
                    tags=("reduction",)))
    register(OpSpec("cumsum_rev_axis", lambda x: pd.cumsum(x, 1), 1, True,
                    shape=(3, 4), ref=lambda x: np.cumsum(x, 1),
                    tags=("manipulation",)))
    register(OpSpec("squeeze_all", lambda x: mp.squeeze(x), 1, True,
                    shape=(1, 3, 1), ref=np.squeeze, tags=("manipulation",)))
    register(OpSpec("amax_axis", lambda x: r.amax(x, axis=1), 1, True,
                    shape=(3, 4), ref=lambda x: x.max(1),
                    tags=("reduction",)))
    register(OpSpec("prod_axis", lambda x: r.prod(x, axis=1), 1, True,
                    shape=(3, 4), domain=_POS, ref=lambda x: x.prod(1),
                    rtol=1e-4, tags=("reduction",)))
    register(OpSpec("matmul_tn",
                    lambda a, b: la.matmul(a, b, transpose_x=True), 2, True,
                    shapes=((3, 2), (3, 4)), ref=lambda a, b: a.T @ b,
                    tags=("linalg",)))
    register(OpSpec("matmul_nt",
                    lambda a, b: la.matmul(a, b, transpose_y=True), 2, True,
                    shapes=((2, 3), (4, 3)), ref=lambda a, b: a @ b.T,
                    tags=("linalg",)))

    # ---- geometric segment ops

    # ---- nn.functional (ROADMAP.md Queue 1 item 1e)
    from ..nn import functional as F

    register(OpSpec("softplus_beta",
                    lambda x: F.softplus(x, beta=2.0), 1, True,
                    ref=lambda x: np.log1p(np.exp(2 * x)) / 2.0,
                    tags=("special",)))
    register(OpSpec("l2_normalize_axis",
                    lambda x: F.normalize(x, axis=0), 1, True,
                    ref=lambda x: x / np.linalg.norm(x, axis=0,
                                                     keepdims=True),
                    tags=("reduction",)))
    register(OpSpec("linear_op",
                    lambda x, w, b: F.linear(x, w, b), 3, True,
                    shapes=((2, 4), (4, 3), (3,)),
                    ref=lambda x, w, b: x @ w + b, tags=("nn",)))
    register(OpSpec("conv2d_op",
                    lambda x, w: F.conv2d(x, w), 2, True,
                    shapes=((1, 2, 5, 5), (3, 2, 3, 3)), rtol=1e-4,
                    tags=("nn",)))
    register(OpSpec("conv1d_op", lambda x, w: F.conv1d(x, w), 2, True,
                    shapes=((1, 2, 6), (3, 2, 3)), rtol=1e-4, tags=("nn",)))
    register(OpSpec("conv3d_op", lambda x, w: F.conv3d(x, w), 2, True,
                    shapes=((1, 1, 4, 4, 4), (2, 1, 2, 2, 2)), rtol=1e-4,
                    tags=("nn",)))
    register(OpSpec("conv2d_transpose_op",
                    lambda x, w: F.conv2d_transpose(x, w), 2, True,
                    shapes=((1, 3, 4, 4), (3, 2, 3, 3)), rtol=1e-4,
                    tags=("nn",)))
    register(OpSpec("layer_norm_op",
                    lambda x, w, b: F.layer_norm(x, [4], w, b), 3, True,
                    shapes=((3, 4), (4,), (4,)), rtol=1e-4, tags=("nn",)))
    register(OpSpec("group_norm_op",
                    lambda x: F.group_norm(x, 2), 1, True,
                    shape=(2, 4, 3, 3), rtol=1e-4, tags=("nn",)))
    register(OpSpec("instance_norm_op", lambda x: F.instance_norm(x), 1,
                    True, shape=(2, 3, 4, 4), rtol=1e-4, tags=("nn",)))
    register(OpSpec("rms_norm_op", lambda x, w: F.rms_norm(x, w), 2, True,
                    shapes=((3, 4), (4,)), rtol=1e-4, tags=("nn",)))
    register(OpSpec("embedding_op",
                    lambda i, w: F.embedding(i, w), 2, True,
                    shapes=((5,), (6, 4)), int_inputs=(0,), int_high=6,
                    ref=lambda i, w: w[i], tags=("nn",)))
    register(OpSpec("one_hot_op", lambda i: F.one_hot(i, 6), 1, False,
                    shape=(4,), int_inputs=(0,), int_high=6, bf16=False,
                    ref=lambda i: np.eye(6)[i], tags=("nn",)))
    register(OpSpec("max_pool2d_op",
                    lambda x: F.max_pool2d(x, 2), 1, True,
                    shape=(1, 2, 4, 4), tags=("nn",)))
    register(OpSpec("avg_pool2d_op", lambda x: F.avg_pool2d(x, 2), 1, True,
                    shape=(1, 2, 4, 4), tags=("nn",)))
    register(OpSpec("adaptive_avg_pool2d_op",
                    lambda x: F.adaptive_avg_pool2d(x, 2), 1, True,
                    shape=(1, 2, 6, 6), tags=("nn",)))
    register(OpSpec("max_pool2d_mask",
                    lambda x: F.max_pool2d(x, 2, return_mask=True)[0], 1,
                    True, shape=(1, 2, 4, 4), tags=("nn",)))
    register(OpSpec("max_unpool2d_op",
                    lambda x: F.max_unpool2d(*F.max_pool2d(
                        x, 2, return_mask=True), 2), 1, True,
                    shape=(1, 2, 4, 4), tags=("nn",)))
    register(OpSpec("unfold_op", lambda x: F.unfold(x, 2), 1, True,
                    shape=(1, 2, 4, 4), tags=("nn",)))
    register(OpSpec("fold_op",
                    lambda x: F.fold(x, [4, 4], [2, 2]), 1, True,
                    shape=(1, 8, 9), tags=("nn",)))
    register(OpSpec("pixel_shuffle_op",
                    lambda x: F.pixel_shuffle(x, 2), 1, True,
                    shape=(1, 4, 3, 3), tags=("nn",)))
    register(OpSpec("pixel_unshuffle_op",
                    lambda x: F.pixel_unshuffle(x, 2), 1, True,
                    shape=(1, 1, 4, 4), tags=("nn",)))
    register(OpSpec("channel_shuffle_op",
                    lambda x: F.channel_shuffle(x, 2), 1, True,
                    shape=(1, 4, 3, 3), tags=("nn",)))
    register(OpSpec("interpolate_op",
                    lambda x: F.interpolate(x, scale_factor=2,
                                            mode="bilinear"), 1, True,
                    shape=(1, 2, 3, 3), tags=("nn",)))
    register(OpSpec("grid_sample_op",
                    lambda x, g: F.grid_sample(x, g), 2, True,
                    shapes=((1, 2, 4, 4), (1, 3, 3, 2)),
                    domains=(_SAFE, _UNIT), rtol=1e-4, tags=("nn",)))
    register(OpSpec("affine_grid_op",
                    lambda t: F.affine_grid(t, [1, 1, 3, 3]), 1, True,
                    shape=(1, 2, 3), tags=("nn",)))
    register(OpSpec("glu_op", F.glu, 1, True, shape=(3, 4), tags=("nn",)))
    register(OpSpec("swiglu_op", lambda x: F.swiglu(x), 1, True,
                    shape=(3, 4), tags=("nn",)))
    register(OpSpec("prelu_op",
                    lambda x, w: F.prelu(x, w), 2, True,
                    shapes=((2, 3), (1,)), tags=("nn",)))
    register(OpSpec("temporal_shift_op",
                    lambda x: F.temporal_shift(x, 2), 1, True,
                    shape=(4, 4, 3, 3), tags=("nn",)))
    register(OpSpec("pad_reflect",
                    lambda x: F.pad(x, [1, 1, 1, 1], mode="reflect"), 1,
                    True, shape=(1, 2, 3, 3), tags=("nn",)))
    register(OpSpec("zeropad2d_op", lambda x: F.zeropad2d(x, [1, 1, 1, 1]),
                    1, True, shape=(1, 2, 3, 3), tags=("nn",)))
    register(OpSpec("dropout_eval",
                    lambda x: F.dropout(x, 0.5, training=False), 1, True,
                    ref=lambda x: x, tags=("nn",)))
    register(OpSpec("bilinear_op",
                    lambda a, b, w: F.bilinear(a, b, w), 3, True,
                    shapes=((3, 2), (3, 4), (5, 2, 4)), rtol=1e-4,
                    tags=("nn",)))
    register(OpSpec("bce", lambda p, t: F.binary_cross_entropy(
        m.sigmoid(p), m.sigmoid(t)), 2, True, no_grad_inputs=(1,), tags=("loss",)))
    register(OpSpec("bce_logits",
                    lambda p, t: F.binary_cross_entropy_with_logits(
                        p, m.sigmoid(t)), 2, True, no_grad_inputs=(1,), tags=("loss",)))
    register(OpSpec("nll", lambda lp, i: F.nll_loss(
        F.log_softmax(lp), i), 2, True, shapes=((4, 5), (4,)),
        int_inputs=(1,), int_high=5, tags=("loss",)))
    register(OpSpec("cross_entropy_op", lambda lg, i: F.cross_entropy(
        lg, i), 2, True, shapes=((4, 5), (4,)), int_inputs=(1,),
        int_high=5, tags=("loss",)))
    register(OpSpec("margin_ranking",
                    lambda a, b, y: F.margin_ranking_loss(
                        a, b, m.sign(y)), 3, True, no_grad_inputs=(2,), tags=("loss",)))
    register(OpSpec("soft_margin", lambda x, y: F.soft_margin_loss(
        x, m.sign(y)), 2, True, no_grad_inputs=(1,), tags=("loss",)))
    register(OpSpec("triplet_margin",
                    lambda a, p, n2: F.triplet_margin_loss(a, p, n2), 3,
                    True, shapes=((3, 4), (3, 4), (3, 4)), tags=("loss",)))
    register(OpSpec("poisson_nll", lambda x, y: F.poisson_nll_loss(
        x, m.abs(y)), 2, True, no_grad_inputs=(1,), tags=("loss",)))
    register(OpSpec("gaussian_nll",
                    lambda x, y, v: F.gaussian_nll_loss(x, y, m.abs(v) + 0.1),
                    3, True, tags=("loss",)))
    register(OpSpec("multi_label_soft_margin",
                    lambda x, y: F.multi_label_soft_margin_loss(
                        x, (m.sign(y) + 1) / 2), 2, True, no_grad_inputs=(1,), tags=("loss",)))
    register(OpSpec("square_error_cost",
                    F.square_error_cost, 2, True,
                    ref=lambda a, b: (a - b) ** 2, tags=("loss",)))
    register(OpSpec("log_loss",
                    lambda p, t: F.log_loss(m.sigmoid(p), m.sigmoid(t)), 2,
                    True, tags=("loss",)))
    register(OpSpec("dice_loss",
                    lambda p, i: F.dice_loss(F.softmax(p), i), 2, True,
                    shapes=((3, 5), (3, 1)), int_inputs=(1,), int_high=5,
                    tags=("loss",)))
    register(OpSpec("npair",
                    lambda a, p: F.npair_loss(a, p, pd.to_tensor(
                        np.arange(3).astype("int64"))), 2, True,
                    shapes=((3, 4), (3, 4)), rtol=1e-4, tags=("loss",)))
    register(OpSpec("label_smooth_op",
                    lambda lab: F.label_smooth(lab), 1, True,
                    shape=(3, 5), domain=(0.0, 1.0),
                    ref=lambda lab: 0.9 * lab + 0.1 / 5, tags=("loss",)))
    register(OpSpec("gather_tree", lambda i, p: F.gather_tree(i, p), 2,
                    False, shapes=((3, 2, 4), (3, 2, 4)),
                    int_inputs=(0, 1), int_high=4, bf16=False,
                    tags=("search",)))
    register(OpSpec("softmax_axis0", lambda x: F.softmax(x, axis=0), 1,
                    True, ref=lambda x: _np_softmax(x, 0),
                    tags=("activation",)))
