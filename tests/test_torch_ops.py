"""The port's tensor ops: the contracts of tests/test_ops.py and
tests/test_ops_extras.py that fall in the ported op modules, held to
paddle_tpu on the same inputs where the reference computes them, and the
random ops (CPU).

The random ops draw from the port's own generators (one torch.Generator
per device, seeded by `seed`), so their values cannot equal jax's: they
are held to shapes, dtypes (the reference's, checked against it), ranges,
moments within 4 standard errors over 10^5 samples, and repetition under
the same seed. Gradients are held to the reference's tape, which runs
with `FLAGS_eager_defer_vjp=False` (its deferred-VJP pass reads a
removed `jax.core.Var`), set and restored here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core.dtype import dtype_name

N = 100_000


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = port_device._current
    paddle.set_device("cpu")
    old = ref.get_flags(["FLAGS_eager_defer_vjp"])
    ref.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref.set_flags(old)
    port_device._current = prev


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.numpy()


def _both(fn, *arrays, rtol=1e-5, atol=1e-6):
    """fn(pkg, *tensors) on both packages, compared (dtype and values;
    tuples and lists elementwise)."""
    mine = fn(paddle, *[paddle.to_tensor(a) for a in arrays])
    theirs = fn(ref, *[ref.to_tensor(a) for a in arrays])
    ms = mine if isinstance(mine, (list, tuple)) else [mine]
    ts = theirs if isinstance(theirs, (list, tuple)) else [theirs]
    assert len(ms) == len(ts)
    for m, r in zip(ms, ts):
        assert dtype_name(m.dtype) == np.dtype(r.dtype).name
        np.testing.assert_allclose(m.numpy().astype("float64"),
                                   np.asarray(r._data).astype("float64"),
                                   rtol=rtol, atol=atol)
    return mine


def _tape(pkg, fn, arrays, grad_of):
    """Gradients of fn(pkg, *tensors).sum() for the inputs in grad_of,
    from pkg's own tape."""
    ts = [pkg.to_tensor(a, stop_gradient=i not in grad_of)
          for i, a in enumerate(arrays)]
    fn(pkg, *ts).sum().backward()
    return [ts[i].grad.numpy() for i in grad_of]


def _same_grads(fn, *arrays, grad_of=(0,)):
    """The port's gradients equal the reference tape's on the same
    inputs."""
    for m, r in zip(_tape(paddle, fn, arrays, grad_of),
                    _tape(ref, fn, arrays, grad_of)):
        np.testing.assert_allclose(m, r, rtol=1e-6, atol=1e-7)


UNARY = ["abs", "exp", "sin", "cos", "tanh", "floor", "ceil", "round",
         "sign", "square", "erf", "expm1", "sigmoid", "atan", "sinh",
         "trunc", "frac", "neg", "deg2rad"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_matches_reference(name):
    _both(lambda p, x: getattr(p, name)(x), rnd(3, 4) * 3)


BINARY = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
          "pow", "atan2", "fmax", "fmin", "floor_divide", "mod",
          "remainder", "hypot", "logaddexp", "copysign", "heaviside"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_matches_reference(name):
    a, b = np.abs(rnd(3, 4)) + 0.1, rnd(3, 4, seed=1) + 2.0
    _both(lambda p, x, y: getattr(p, name)(x, y), a, b)


def test_integer_division_signs_match_reference():
    a = np.array([-7, -3, 3, 7], "int64")
    b = np.array([2, -2, -2, 2], "int64")
    for name in ("floor_divide", "mod", "remainder", "floor_mod"):
        _both(lambda p, x, y: getattr(p, name)(x, y), a, b)
    _both(lambda p, x, y: p.divide(x, y), a, b)


def test_broadcasting():
    a, b = rnd(3, 1, 4), rnd(5, 1)
    _both(lambda p, x, y: p.add(x, y), a, b)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "prod",
                                  "amax", "amin", "logsumexp", "nansum"])
@pytest.mark.parametrize("axis,keepdim", [(None, False), (0, False),
                                          (1, True), ([0, 2], False),
                                          (None, True), ([], False)])
def test_reduce_matches_reference(name, axis, keepdim):
    _both(lambda p, x: getattr(p, name)(x, axis=axis, keepdim=keepdim),
          rnd(2, 3, 4))


def test_integer_reductions_and_defaults_match_reference():
    x = np.random.RandomState(2).randint(-5, 5, (3, 4)).astype("int32")
    for fn in (lambda p, v: p.sum(v), lambda p, v: p.prod(v, axis=1),
               lambda p, v: p.mean(v), lambda p, v: p.argmax(v),
               lambda p, v: p.argmax(v, axis=1, keepdim=True),
               lambda p, v: p.argmin(v, axis=0),
               lambda p, v: p.cumsum(v), lambda p, v: p.clip(v, 0, 2),
               lambda p, v: p.clip(v, -1.5, 2.5),
               lambda p, v: p.count_nonzero(v, axis=1),
               lambda p, v: p.all(v, axis=0), lambda p, v: p.any(v)):
        _both(fn, x)
    _both(lambda p: p.arange(5))
    _both(lambda p: p.arange(0.0, 1.0, 0.25))
    _both(lambda p: p.full([2], 3))
    _both(lambda p: p.full([2], True))


def test_median_quantile_and_friends_match_reference():
    x = rnd(4, 6)
    for fn in (lambda p, v: p.median(v), lambda p, v: p.median(v, axis=1),
               lambda p, v: p.median(v, axis=0, keepdim=True),
               lambda p, v: p.median(v, axis=1, mode="min"),
               lambda p, v: p.nanmedian(v, axis=1),
               lambda p, v: p.quantile(v, 0.3, axis=1),
               lambda p, v: p.quantile(v, [0.25, 0.75], axis=0),
               lambda p, v: p.nanquantile(v, 0.5),
               lambda p, v: p.kthvalue(v, 2, axis=0),
               lambda p, v: p.std(v, axis=1), lambda p, v: p.var(v),
               lambda p, v: p.cummax(v, axis=1),
               lambda p, v: p.cummin(v, axis=0),
               lambda p, v: p.logcumsumexp(v, axis=1),
               lambda p, v: p.norm(v, p=3, axis=1),
               lambda p, v: p.norm(v, p="nuc"),
               lambda p, v: p.topk(v, 2, axis=0, largest=False)):
        _both(fn, x, rtol=1e-5, atol=1e-5)
    y = x.copy()
    y[0, 1] = np.nan
    _both(lambda p, v: p.nanmedian(v, axis=1), y)
    z = np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], "int64")
    _both(lambda p, v: p.mode(v, axis=1), z)


def test_matmul_shapes_and_flags():
    for sa, sb in [((3, 4), (4, 5)), ((2, 3, 4), (2, 4, 5)), ((4,), (4,)),
                   ((2, 3, 4), (4,))]:
        _both(lambda p, a, b: p.matmul(a, b), rnd(*sa), rnd(*sb, seed=1),
              rtol=1e-4, atol=1e-5)
    _both(lambda p, a, b: p.matmul(a, b, transpose_x=True), rnd(4, 3),
          rnd(4, 5), rtol=1e-4, atol=1e-5)
    _both(lambda p, a, b: p.einsum("ij,jk->ik", a, b), rnd(3, 4),
          rnd(4, 5), rtol=1e-4, atol=1e-5)


def test_manipulation_matches_reference():
    x = rnd(2, 3, 4)
    for fn in (lambda p, v: p.reshape(v, [6, 4]),
               lambda p, v: p.transpose(v, [2, 0, 1]),
               lambda p, v: p.flatten(v, 1),
               lambda p, v: p.squeeze(p.unsqueeze(v, [0, 2]), [0, 2]),
               lambda p, v: p.concat([v, v], axis=1),
               lambda p, v: p.stack([v, v], axis=2),
               lambda p, v: p.split(v, [1, 2], axis=1),
               lambda p, v: p.chunk(v, 2, axis=2),
               lambda p, v: p.tile(v, [2, 1, 1]),
               lambda p, v: p.flip(v, [0, 2]),
               lambda p, v: p.roll(v, 1, 0), lambda p, v: p.roll(v, [1, 2]),
               lambda p, v: p.expand(p.unsqueeze(v, 0), [3, -1, -1, -1]),
               lambda p, v: p.moveaxis(v, 0, 2), lambda p, v: p.t(v[0]),
               lambda p, v: p.unbind(v, 1), lambda p, v: p.unstack(v, 2),
               lambda p, v: p.rot90(v, 1, [1, 2]),
               lambda p, v: p.unfold(v, 0, 1, 1),
               lambda p, v: p.tensor_split(v, 2, axis=2),
               lambda p, v: p.strided_slice(v, [2], [3], [0], [-1]),
               lambda p, v: p.slice(v, [1, 2], [-2, 1], [100, 3]),
               lambda p, v: p.pad(v, [1, 1, 0, 2], mode="reflect"),
               lambda p, v: p.pad(v, [1, 2], mode="replicate"),
               lambda p, v: p.pad(v, [1, 0, 2, 2], mode="circular"),
               lambda p, v: p.pad(v, [1, 1], value=2.0),
               lambda p, v: p.diff(v, axis=1),
               lambda p, v: p.trapezoid(v, dx=0.5),
               lambda p, v: p.cumulative_trapezoid(v),
               lambda p, v: p.as_strided(v, [2, 2], [4, 1], 1),
               lambda p, v: p.repeat_interleave(v, 2, axis=1),
               lambda p, v: p.atleast_3d(v[0, 0]),
               lambda p, v: p.hstack([v, v]), lambda p, v: p.dstack([v, v])):
        _both(fn, x)


def test_unfold_windows_every_axis():
    """At axis 0 as the reference; at the others Paddle's meaning (the
    reference's composition scrambles them: ROADMAP.md Queue 3 F8),
    held to numpy's sliding windows."""
    x = rnd(5, 3, 4)
    _both(lambda p, v: p.unfold(v, 0, 2, 1), x)
    for ax in (1, 2):
        win = np.lib.stride_tricks.sliding_window_view(x, 2, axis=ax)
        np.testing.assert_array_equal(
            paddle.unfold(paddle.to_tensor(x), ax, 2, 1).numpy(), win)


def test_creation_matches_reference():
    for fn in (lambda p: p.zeros([2, 3]), lambda p: p.ones([2], "int32"),
               lambda p: p.eye(3, 2), lambda p: p.full([2], 7.0),
               lambda p: p.linspace(0, 1, 5), lambda p: p.logspace(0, 2, 3),
               lambda p: p.tril_indices(4, 3, 1),
               lambda p: p.triu_indices(3, 4, -1),
               lambda p: p.arange(2, 11, 3)):
        _both(fn, rtol=1e-5)
    x = rnd(2, 3)
    for fn in (lambda p, v: p.zeros_like(v), lambda p, v: p.ones_like(v),
               lambda p, v: p.full_like(v, 2.5), lambda p, v: p.diag(v[0]),
               lambda p, v: p.diag(v[0], 1, padding_value=9),
               lambda p, v: p.diag(v), lambda p, v: p.diagflat(v),
               lambda p, v: p.diag_embed(v, 1), lambda p, v: p.tril(v, -1),
               lambda p, v: p.meshgrid(v[0], v[1, :2]),
               lambda p, v: p.assign(v), lambda p, v: p.clone(v)):
        _both(fn, x)
    np.testing.assert_array_equal(paddle.assign(x).numpy(), x)
    out = paddle.zeros([2, 3])
    paddle.assign(paddle.to_tensor(x), output=out)
    np.testing.assert_array_equal(out.numpy(), x)


def test_indexing_gather_scatter_match_reference():
    x = rnd(5, 3)
    i2 = np.array([0, 2], "int64")
    for fn in (lambda p, v, i: p.gather(v, i),
               lambda p, v, i: p.index_select(v, i, axis=0),
               lambda p, v, i: p.take(v, i, mode="wrap"),
               lambda p, v, i: p.index_fill(v, i, 1, 7.0),
               lambda p, v, i: p.scatter(v, i, v[:2] * 0 + 1.0),
               lambda p, v, i: p.scatter(v, i, v[:2], overwrite=False),
               lambda p, v, i: p.index_add(v, i, 0, v[:2]),
               lambda p, v, i: p.index_put(v, [i], v[:2] * 2),
               lambda p, v, i: p.gather_nd(v, p.reshape(i, [2, 1])),
               lambda p, v, i: p.scatter_nd_add(v, p.reshape(i, [2, 1]),
                                                v[:2]),
               lambda p, v, i: p.put_along_axis(
                   v, p.reshape(i[:1], [1, 1]), 9.0, 0),
               lambda p, v, i: p.put_along_axis(
                   v, p.reshape(i, [2, 1]).tile([1, 3]), v[:2], 0,
                   reduce="add"),
               lambda p, v, i: p.take_along_axis(
                   v, p.reshape(i, [2, 1]), 0),
               lambda p, v, i: p.masked_select(v, v > 0),
               lambda p, v, i: p.masked_fill(v, v > 0, 0.5),
               lambda p, v, i: p.where(v > 0, v, 0.0),
               lambda p, v, i: p.nonzero(v > 0),
               lambda p, v, i: p.nonzero(v > 0, as_tuple=True),
               lambda p, v, i: p.select_scatter(v, v[0], 0, 1),
               lambda p, v, i: p.slice_scatter(v, v[:, 1:3] * 0, [1], [1],
                                               [3], [1]),
               lambda p, v, i: p.diagonal_scatter(v[:3], v[0], 0)):
        _both(fn, x, i2)


def test_repeated_indices_take_the_last_write():
    """A write to one place from several entries keeps the last (the
    reference's sequential answer; the card's scatter would pick any),
    and only that entry gets a gradient."""
    x = np.zeros((3, 4), "float32")
    i = np.array([[1, 1], [0, 2], [3, 3]])
    v = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], "float32")
    _both(lambda p, a, b, c: p.put_along_axis(a, b, c, 1), x, i, v)
    _both(lambda p, a, b, c: p.scatter(a[:, :2], b[:, 0], c), x,
          np.array([[0], [0], [2]]), v)
    _both(lambda p, a, b, c: p.index_put(a, [b[0], b[0] * 0], c[0]), x,
          np.array([[1, 1]]), v)
    _same_grads(lambda p, a, b, c: p.put_along_axis(a, b, c, 1), x, i, v,
                grad_of=(0, 2))
    rows = np.array([0, 0, 2])
    for overwrite in (True, False):
        _same_grads(lambda p, a, b, c: p.scatter(a, b, c, overwrite),
                    x[:, :2], rows, v, grad_of=(0, 2))
    _same_grads(lambda p, a, b, c: p.index_put(a, [b, b * 0], c), x,
                np.array([1, 1]), v[0], grad_of=(0, 2))


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


def test_sort_search_unique_match_reference():
    x = rnd(4, 5)
    for fn in (lambda p, v: p.sort(v, axis=0),
               lambda p, v: p.sort(v, descending=True),
               lambda p, v: p.argsort(v, axis=1),
               lambda p, v: p.argsort(v, descending=True),
               lambda p, v: p.topk(v, 3, axis=1),
               lambda p, v: p.searchsorted(p.sort(v[0]), v[1]),
               lambda p, v: p.searchsorted(p.sort(v[:2], axis=1), v[2:],
                                           right=True),
               lambda p, v: p.bucketize(v[1], p.sort(v[0]))):
        _both(fn, x)
    a = np.array([3, 1, 1, 2, 3, 3], "int64")
    _both(lambda p, v: p.unique(v, return_index=True, return_inverse=True,
                                return_counts=True), a)
    _both(lambda p, v: p.unique(p.reshape(v, [3, 2]), axis=0), a)
    _both(lambda p, v: p.unique_consecutive(v, return_inverse=True,
                                            return_counts=True), a)


def test_argsort_descending_stable_integers():
    for dt in ("uint8", "int32", "int64"):
        a = np.array([3, 0, 5, 0, 3, 1], dtype=dt)
        if dt != "uint8":
            a[1] = np.iinfo(dt).min
        idx = paddle.argsort(paddle.to_tensor(a), descending=True,
                             stable=True).numpy()
        vals = a[idx].astype(np.int64)
        assert (np.diff(vals) <= 0).all(), (dt, vals)
        for v in np.unique(a):
            pos = idx[a[idx] == v]
            assert (np.diff(pos) > 0).all(), (dt, v, pos)
    ib = paddle.argsort(paddle.to_tensor(np.array([True, False, True,
                                                   False])),
                        descending=True, stable=True).numpy()
    assert list(ib) == [0, 2, 1, 3]


def test_cast_and_dtypes():
    x = paddle.to_tensor(rnd(2, 2))
    assert paddle.cast(x, "float64").dtype == paddle.float64
    assert paddle.cast(x, paddle.int32).dtype == paddle.int32
    assert x.astype("bool").dtype == paddle.bool
    assert paddle.cast(x, paddle.bfloat16).dtype == paddle.bfloat16
    assert paddle.cast(x, "float32") is x


def test_scalar_tensor_interop():
    x = rnd(2, 2)
    t = paddle.to_tensor(x)
    np.testing.assert_allclose((t + 1.0).numpy(), x + 1.0)
    np.testing.assert_allclose((2.0 * t).numpy(), 2 * x)
    np.testing.assert_allclose((1.0 - t).numpy(), 1 - x, rtol=1e-6)
    np.testing.assert_allclose((t / 2).numpy(), x / 2)
    np.testing.assert_allclose((t ** 2).numpy(), x ** 2)
    np.testing.assert_allclose((-t).numpy(), -x)


def test_special_functions_match_reference():
    x = np.array([0.5, 1.5, 3.0], "float32")
    y = np.array([1.0, 2.0, 0.5], "float32")
    for fn in (lambda p, a, b: p.gammaln(a),
               lambda p, a, b: p.gammainc(a, b),
               lambda p, a, b: p.gammaincc(a, b),
               lambda p, a, b: p.multigammaln(a + 1.0, 2),
               lambda p, a, b: p.polygamma(a, 1), lambda p, a, b: p.i0e(a),
               lambda p, a, b: p.i1(a), lambda p, a, b: p.i1e(b),
               lambda p, a, b: p.sinc(a), lambda p, a, b: p.digamma(a),
               lambda p, a, b: p.lgamma(a), lambda p, a, b: p.erfinv(b / 3),
               lambda p, a, b: p.logit(b / 3, eps=0.1),
               lambda p, a, b: p.frexp(a * 5),
               lambda p, a, b: p.nextafter(a, b),
               lambda p, a, b: p.ldexp(a, b)):
        _both(fn, x, y, rtol=2e-5)


def test_gammainc_gradient_in_both_arguments():
    a = paddle.to_tensor(np.array([0.5, 1.5, 3.0], "float64"),
                         stop_gradient=False)
    x = paddle.to_tensor(np.array([1.0, 2.0, 0.5], "float64"),
                         stop_gradient=False)
    paddle.gammainc(a, x).sum().backward()

    def f(av, xv):
        return float(torch.special.gammainc(torch.tensor(av),
                                            torch.tensor(xv)).sum())

    eps = 1e-6
    av, xv = a.numpy(), x.numpy()
    for i in range(3):
        d = np.zeros(3)
        d[i] = eps
        ga = (f(av + d, xv) - f(av - d, xv)) / (2 * eps)
        gx = (f(av, xv + d) - f(av, xv - d)) / (2 * eps)
        assert a.grad.numpy()[i] == pytest.approx(ga, rel=1e-5)
        assert x.grad.numpy()[i] == pytest.approx(gx, rel=1e-5)


def test_complex_and_bitwise_match_reference():
    x = rnd(3, 4, 2)
    _both(lambda p, v: p.as_real(p.as_complex(v)), x)
    z = np.array([3 + 4j, 0j], "complex64")
    _both(lambda p, v: p.sgn(v), z)
    _both(lambda p, v: p.isreal(v), np.array([1 + 0j, 1 + 1j], "complex64"))
    _both(lambda p, v: p.real(p.as_complex(v)), x)
    _both(lambda p, v: p.imag(p.as_complex(v)), x)
    i = np.array([8, 16, -32], "int32")
    s = np.array([1, 2, 3], "int32")
    for fn in (lambda p, a, b: p.bitwise_left_shift(a, b),
               lambda p, a, b: p.bitwise_right_shift(a, b),
               lambda p, a, b: p.bitwise_right_shift(a, b,
                                                     is_arithmetic=False),
               lambda p, a, b: p.bitwise_invert(a),
               lambda p, a, b: p.gcd(a, b), lambda p, a, b: p.lcm(a, b)):
        _both(fn, i, s)


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


def test_linalg_matches_reference():
    rs = np.random.RandomState(5)
    a = rs.randn(4, 4).astype("float32")
    spd = a @ a.T + 4 * np.eye(4, dtype="float32")
    for fn in (lambda p, v: p.linalg.cholesky(v),
               lambda p, v: p.linalg.inv(v), lambda p, v: p.linalg.det(v),
               lambda p, v: p.linalg.slogdet(v),
               lambda p, v: p.linalg.eigvalsh(v),
               lambda p, v: p.linalg.svd(v)[1],
               lambda p, v: p.linalg.matrix_power(v, 3),
               lambda p, v: p.linalg.matrix_rank(v),
               lambda p, v: p.linalg.cond(v),
               lambda p, v: p.linalg.pinv(v),
               lambda p, v: p.linalg.solve(v, v[:, :2]),
               lambda p, v: p.linalg.triangular_solve(v, v[:, :2],
                                                      upper=False,
                                                      transpose=True),
               lambda p, v: p.linalg.cholesky_solve(
                   v[:, :2], p.linalg.cholesky(v)),
               lambda p, v: p.cholesky_inverse(p.linalg.cholesky(v)),
               lambda p, v: p.linalg.lstsq(v[:, :3], v[:, 3:])[0],
               lambda p, v: p.linalg.multi_dot([v, v, v]),
               lambda p, v: p.linalg.cov(v), lambda p, v: p.linalg.corrcoef(v),
               lambda p, v: p.kron(v[:2, :2], v[:2, :3]),
               lambda p, v: p.cross(v[:3, :3], v[1:, :3], axis=0),
               lambda p, v: p.tensordot(v, v, axes=[[1], [0]]),
               lambda p, v: p.outer(v[0], v[1]), lambda p, v: p.inner(v, v),
               lambda p, v: p.addmm(v, v, v, beta=0.5, alpha=2.0)):
        _both(fn, spd, rtol=1e-4, atol=1e-4)


def test_lu_unpack_and_ormqr():
    import scipy.linalg as sl

    rs = np.random.RandomState(6)
    a = rs.randn(4, 4).astype("float32")
    lu_t, piv = paddle.linalg.lu(paddle.to_tensor(a))
    rlu, rpiv = ref.linalg.lu(ref.to_tensor(a))
    np.testing.assert_allclose(lu_t.numpy(), np.asarray(rlu._data),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv._data))
    p, lo, up = paddle.lu_unpack(lu_t, piv)
    np.testing.assert_allclose(_np(p) @ _np(lo) @ _np(up), a, rtol=1e-4,
                               atol=1e-5)
    b = rs.randn(4, 3).astype("float32")
    (h, tau), _ = sl.qr(b, mode="raw")
    other = rs.randn(4, 2).astype("float32")
    got = paddle.ormqr(paddle.to_tensor(h), paddle.to_tensor(tau),
                       paddle.to_tensor(other))
    np.testing.assert_allclose(_np(got), sl.qr(b)[0] @ other, rtol=1e-4,
                               atol=1e-4)
    hp = paddle.householder_product(paddle.to_tensor(h),
                                    paddle.to_tensor(tau))
    hr = ref.linalg.householder_product(ref.to_tensor(h), ref.to_tensor(tau))
    np.testing.assert_allclose(_np(hp), np.asarray(hr._data), rtol=1e-5,
                               atol=1e-5)


def test_bulk_inplace_and_friends():
    x = np.array([0.5, 1.0], "float32")
    for name in ("cos_", "log1p_", "square_", "sigmoid_", "erf_"):
        tm, tr = paddle.to_tensor(x), ref.to_tensor(x)
        getattr(tm, name)()
        getattr(tr, name)()
        np.testing.assert_allclose(tm.numpy(), np.asarray(tr._data),
                                   rtol=1e-6)
    t = paddle.to_tensor(np.array([1.0, 2.0], "float32"), stop_gradient=False)
    y = t * 2.0
    y.tanh_()
    y.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(),
                               (1 - np.tanh([2.0, 4.0]) ** 2) * 2, rtol=1e-3)
    cond = paddle.to_tensor(np.array([True, False]))
    xs = paddle.to_tensor(np.array([1.0, 2.0], "float32"))
    out = paddle.where_(cond, xs, paddle.to_tensor(np.array([9.0, 9.0],
                                                            "float32")))
    assert out is xs
    np.testing.assert_allclose(xs.numpy(), [1.0, 9.0])
    b = paddle.zeros([2, 2])
    b.set_(paddle.ones([3, 3]))
    assert b.shape == [3, 3]
    r = paddle.to_tensor(np.arange(4.0, dtype="float32"))
    r.resize_([2, 3])
    np.testing.assert_array_equal(r.numpy(), np.resize(np.arange(4.0),
                                                       (2, 3)))
    m = paddle.zeros([3, 3])
    m.fill_diagonal_(2.0, offset=1)
    rm = ref.zeros([3, 3])
    rm.fill_diagonal_(2.0, offset=1)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm._data))
    inc = paddle.to_tensor(np.array([1.0], "float32"))
    paddle.increment(inc, 2.0)
    assert inc.item() == 3.0


def test_ops_module_helpers_match_reference():
    x = rnd(2, 5)
    assert paddle.numel(paddle.to_tensor(x)).item() == 10
    assert paddle.numel(paddle.to_tensor(x)).dtype == paddle.int64
    np.testing.assert_array_equal(paddle.shape(paddle.to_tensor(x)).numpy(),
                                  [2, 5])
    assert paddle.shape(paddle.to_tensor(x)).dtype == paddle.int32
    assert paddle.rank(paddle.to_tensor(x)).item() == 2
    assert paddle.is_tensor(paddle.to_tensor(x)) and not paddle.is_tensor(x)
    _both(lambda p, a, b: p.add_n([a, b, a]), x, x * 2)
    _both(lambda p, a: p.check_shape(a, [2, -1]), x)
    with pytest.raises(ValueError):
        paddle.check_shape(paddle.to_tensor(x), [3, 5])
    # stft is signal's (item 1f), the reference's tensor-level alias
    np.testing.assert_allclose(paddle.stft(paddle.to_tensor(x), 4).numpy(),
                               np.asarray(ref.stft(ref.to_tensor(x), 4)._data),
                               rtol=1e-5, atol=1e-6)
    d, n = paddle.edit_distance(
        paddle.to_tensor(np.array([[1, 2, 3]], "int64")),
        paddle.to_tensor(np.array([[1, 3]], "int64")))
    rd, rn = ref.edit_distance(ref.to_tensor(np.array([[1, 2, 3]], "int64")),
                               ref.to_tensor(np.array([[1, 3]], "int64")))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd._data))
    assert n.item() == int(rn.item())


def test_op_signatures_match_reference():
    """Every top-level op the reference also has takes the reference's
    parameters, in its order (`name=None` included)."""
    import inspect

    from paddle_tpu_torch import ops

    checked, wrong = 0, []
    for n in sorted(set(ops.__all__) | {"to_tensor", "create_parameter",
                                         "seed", "grad", "set_device"}):
        mine, theirs = getattr(paddle, n), getattr(ref, n, None)
        if theirs is None:
            continue
        try:
            a = list(inspect.signature(mine).parameters)
            b = list(inspect.signature(theirs).parameters)
        except (TypeError, ValueError):     # a C builtin on either side
            continue
        checked += 1
        if a != b:
            wrong.append((n, a, b))
    assert checked > 300 and not wrong, wrong


def test_op_boundary_torch_in_torch_out():
    a, b = torch.ones(2, 3), torch.full((2, 3), 2.0)
    assert isinstance(paddle.add(a, b), torch.Tensor)
    assert isinstance(paddle.split(a, 3, axis=1)[0], torch.Tensor)
    assert isinstance(paddle.matmul(paddle.to_tensor(a.numpy()), b.T),
                      paddle.Tensor)
    assert isinstance(paddle.zeros([2]), paddle.Tensor)


# ------------------------------------------------------------ random
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
