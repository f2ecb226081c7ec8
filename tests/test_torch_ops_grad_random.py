"""The second half of test_torch_ops.py (its helpers, rules and
tolerances): gradients at ties and kinks held to the reference's tape,
the reductions-and-manipulation extras, and the random ops (moments
within 4 standard errors over 10^5 samples, dtypes, ranges, repetition
under one seed).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.dtype import dtype_name
from test_torch_ops import (N, _both, _np, _on_cpu,  # noqa: F401
                            _same_grads, rnd)


TIES = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, -1.0, 2.0]], "float32")
KINKS = {
    "max": lambda p, a: p.max(a, axis=1),
    "max_all": lambda p, a: p.max(a),
    "min": lambda p, a: p.min(a, axis=1),
    "amax": lambda p, a: p.amax(a, axis=1),
    "amin": lambda p, a: p.amin(a, axis=0),
    "abs": lambda p, a: p.abs(a),
    "norm_p1": lambda p, a: p.norm(a, p=1, axis=1),
    "norm_inf": lambda p, a: p.norm(a, p=float("inf"), axis=1),
    "median": lambda p, a: p.median(a, axis=1),
    "nanmedian": lambda p, a: p.nanmedian(a, axis=1),
    "kthvalue": lambda p, a: p.kthvalue(a, 2, axis=1)[0],
    "mode": lambda p, a: p.mode(a, axis=1)[0],
    "topk": lambda p, a: p.topk(a, 2, axis=1)[0],
    "topk_smallest": lambda p, a: p.topk(a, 2, axis=1, largest=False)[0],
    "cummax": lambda p, a: p.cummax(a, axis=1)[0],
    "cummin": lambda p, a: p.cummin(a, axis=1)[0],
    "clip": lambda p, a: p.clip(a, 0.0, 2.0),
    "clip_point": lambda p, a: p.clip(a, 2.0, 2.0),
    "maximum": lambda p, a: p.maximum(a, p.flip(a, [1])),
    "sort": lambda p, a: p.sort(a, axis=1) * p.arange(4, dtype="float32"),
}


@pytest.mark.parametrize("name", sorted(KINKS))
def test_tie_and_kink_gradients_match_the_reference_tape(name):
    """Where the gradient is a choice (ties, |x| at 0, a clip's bound),
    the port makes the reference's: on inputs full of ties and zeros, the
    forward and the tape gradient equal paddle_tpu's."""
    _both(KINKS[name], TIES)
    _same_grads(KINKS[name], TIES)


def test_reductions_and_manipulation_extras_match_reference():
    x = rnd(3, 4)
    for fn in (lambda p, v: p.trace(v, 1), lambda p, v: p.diagonal(v, -1),
               lambda p, v: p.reduce_as(v, v[:1]),
               lambda p, v: p.is_empty(v), lambda p, v: p.isin(v, v[0]),
               lambda p, v: p.unflatten(v, 1, [2, -1]),
               lambda p, v: p.vander(v[0], 3),
               lambda p, v: p.vander(v[0], increasing=True),
               lambda p, v: p.block_diag([v, v[:2]]),
               lambda p, v: p.reverse(v, 0), lambda p, v: p.less(v, v * 0.5),
               lambda p, v: p.histogram_bin_edges(v, bins=4, min=-1, max=1),
               lambda p, v: p.histogram(v, bins=4, min=-2, max=2),
               lambda p, v: p.cdist(v, v[:2]),
               lambda p, v: p.cdist(v, v[:2], p=1.0),
               lambda p, v: p.pdist(v), lambda p, v: p.renorm(v, 2.0, 0, 1.0),
               lambda p, v: p.vecdot(v, v), lambda p, v: p.positive(v),
               lambda p, v: p.cartesian_prod([v[0], v[1, :2]]),
               lambda p, v: p.combinations(v[0], 2),
               lambda p, v: p.fill_diagonal_tensor(v, v[0, :3]),
               lambda p, v: p.affine_channel(p.reshape(v, [1, 3, 2, 2]),
                                             v[0, :3], v[1, :3])):
        _both(fn, x, rtol=1e-5, atol=1e-5)
    ids = np.array([[1], [6], [12], [19]], "int64")
    for sid in (0, 1):
        _both(lambda p, v: p.shard_index(v, 20, 2, sid), ids)
    _both(lambda p, v: p.bincount(v, minlength=7), ids.reshape(-1) % 7)


def _moments(vals, mean, var):
    vals = vals.astype("float64").reshape(-1)
    se = np.sqrt(var / vals.size)
    assert abs(vals.mean() - mean) < 4 * se, (vals.mean(), mean, se)
    # the sample variance's standard error, from the fourth moment
    m4 = ((vals - vals.mean()) ** 4).mean()
    se_v = np.sqrt((m4 - vals.var() ** 2) / vals.size)
    assert abs(vals.var() - var) < 4 * se_v, (vals.var(), var, se_v)


RANDOM = {
    "rand": (lambda p, n: p.rand([n]), 0.5, 1 / 12),
    "randn": (lambda p, n: p.randn([n]), 0.0, 1.0),
    "uniform": (lambda p, n: p.uniform([n], min=-2.0, max=-1.0), -1.5, 1 / 12),
    "normal": (lambda p, n: p.normal(1.0, 2.0, [n]), 1.0, 4.0),
    "gaussian": (lambda p, n: p.gaussian([n], mean=-1.0, std=0.5), -1.0, 0.25),
    "standard_normal": (lambda p, n: p.standard_normal([n]), 0.0, 1.0),
    "randint": (lambda p, n: p.randint(0, 10, [n]), 4.5, 99 / 12),
    "log_normal": (lambda p, n: p.log(p.log_normal(0.5, 0.25, [n])), 0.5,
                   0.0625),
    "exponential_": (lambda p, n: p.zeros([n]).exponential_(2.0), 0.5, 0.25),
    "bernoulli": (lambda p, n: p.bernoulli(p.full([n], 0.3)), 0.3, 0.21),
    "poisson": (lambda p, n: p.poisson(p.full([n], 3.0)), 3.0, 3.0),
    "binomial": (lambda p, n: p.binomial(p.full([n], 10.0),
                                      p.full([n], 0.4)), 4.0, 2.4),
    "standard_gamma": (lambda p, n: p.standard_gamma(p.full([n], 2.0)), 2.0,
                       2.0),
    "normal_": (lambda p, n: p.zeros([n]).normal_(3.0, 0.5), 3.0, 0.25),
    "uniform_": (lambda p, n: p.zeros([n]).uniform_(0.0, 4.0), 2.0, 16 / 12),
    "bernoulli_": (lambda p, n: p.zeros([n]).bernoulli_(0.8), 0.8, 0.16),
    "truncated_gaussian_random": (
        lambda p, n: p.truncated_gaussian_random([n], a=-1.0, b=1.0), 0.0,
        0.2911),
    "rand_like": (lambda p, n: p.rand_like(p.zeros([n])), 0.5, 1 / 12),
    "randn_like": (lambda p, n: p.randn_like(p.zeros([n])), 0.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_moments_dtype_and_repetition(name):
    fn, mean, var = RANDOM[name]
    paddle.seed(42)
    a = fn(paddle, N)
    paddle.seed(42)
    b = fn(paddle, N)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = fn(paddle, N)
    assert not np.array_equal(a.numpy(), c.numpy())
    assert a.shape == [N]
    r = fn(ref, 16)                      # the reference's dtype and shape
    small = fn(paddle, 16)
    assert dtype_name(a.dtype) == dtype_name(small.dtype) == np.dtype(
        r.dtype).name
    assert small.shape == list(r.shape)
    _moments(a.numpy(), mean, var)


def test_random_ranges_permutations_and_samplers():
    paddle.seed(7)
    r = paddle.randint(3, 10, [N]).numpy()
    assert r.min() == 3 and r.max() == 9
    assert paddle.randint(5, shape=[4]).dtype == paddle.int64
    perm = paddle.randperm(1000).numpy()
    assert sorted(perm.tolist()) == list(range(1000))
    x = paddle.to_tensor(np.arange(12.0, dtype="float32").reshape(6, 2))
    s = paddle.shuffle(x).numpy()
    assert sorted(s[:, 0].tolist()) == list(range(0, 12, 2))
    assert (s[:, 1] == s[:, 0] + 1).all()
    probs = paddle.to_tensor(np.array([[0.1, 0.0, 0.9]] * 4, "float32"))
    m = paddle.multinomial(probs, 2, replacement=False).numpy()
    assert m.dtype == np.int64 and (m != 1).all()
    u = paddle.uniform([N], seed=3).numpy()
    np.testing.assert_array_equal(u, paddle.uniform([N], seed=3).numpy())
    assert u.min() >= -1.0 and u.max() < 1.0
    il = paddle.randint_like(paddle.zeros([N], "int32"), 0, 4)
    assert il.dtype == paddle.int32 and il.numpy().max() == 3
    st = paddle.get_rng_state()
    a = paddle.rand([8]).numpy()
    paddle.set_rng_state(st)
    np.testing.assert_array_equal(a, paddle.rand([8]).numpy())


def test_cauchy_geometric_fill_and_top_p():
    paddle.seed(3)
    t = paddle.zeros([N])
    t.cauchy_(loc=1.0, scale=2.0)
    vals = t.numpy()
    assert np.isfinite(vals).all()
    # the median of Cauchy(loc, scale) is loc; its sample median's
    # standard error is scale * pi / (2 sqrt(n))
    assert abs(np.median(vals) - 1.0) < 4 * 2.0 * np.pi / (2 * np.sqrt(N))
    g = paddle.zeros([N])
    g.geometric_(0.5)
    gv = g.numpy()
    assert gv.min() >= 1
    _moments(gv, 2.0, 2.0)               # mean 1/p, variance (1-p)/p^2
    probs = np.array([[0.05, 0.05, 0.9], [0.5, 0.49, 0.01]], "float32")
    scores, ids = paddle.top_p_sampling(
        paddle.to_tensor(probs), paddle.to_tensor(np.full((2, 1), 0.5,
                                                          "float32")))
    assert ids.numpy().flatten()[0] == 2
    assert ids.numpy().flatten()[1] in (0, 1)
    assert ids.dtype == paddle.int64 and scores.shape == [2]


def test_svd_lowrank_reconstructs():
    rs = np.random.RandomState(9)
    a = rs.randn(8, 3).astype("float32") @ rs.randn(3, 6).astype("float32")
    paddle.seed(0)
    u, s, v = paddle.svd_lowrank(paddle.to_tensor(a), q=3)
    np.testing.assert_allclose(_np(u) @ np.diag(_np(s)) @ _np(v).T, a,
                               rtol=1e-2, atol=1e-3)
