"""The port's five quantization functions of `incubate.nn.functional`
held to paddle_tpu's on the CPU.

`weight_quantize` (int8, packed int4 with an odd K and group sizes,
llm.int8), `weight_quantize_raw` and `weight_dequantize`: codes and scales
bit-exact, in f32 and bf16. `weight_only_linear` (int8, per-channel and
grouped int4, with and without a bias) and `llm_int8_linear` (outlier
columns, a bias, a 3-D input): outputs within 1e-5 of the largest |value|
in f32, and the gradient of x against the reference's tape
(FLAGS_eager_defer_vjp off), the bias and the scale taking none in both.
The int8 x int8 -> int32 product is exact against an int64 product at
K = 5504. The refusals are the reference's.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops.quantized import int8_matmul

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = port_device._current
    pt.set_device("cpu")
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)
    port_device._current = prev


def _np(t):
    if isinstance(t, paddle.Tensor):
        return np.asarray(t._data.astype("float32")
                          if "bfloat16" in str(t.dtype) else t._data)
    return t._data.float().numpy() if t._data.dtype == torch.bfloat16 \
        else t.numpy()


def _both(arr, dtype="float32"):
    """The same array as a Tensor of each package (bf16 through f32)."""
    r = paddle.to_tensor(arr)
    p = pt.to_tensor(arr)
    if dtype == "bfloat16":
        r, p = r.astype("bfloat16"), p.astype("bfloat16")
    return r, p


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("algo,k,group,dtype", [
    ("weight_only_int8", 16, -1, "float32"),
    ("weight_only_int8", 33, -1, "float32"),
    ("weight_only_int8", 64, -1, "bfloat16"),
    ("weight_only_int4", 16, -1, "float32"),
    ("weight_only_int4", 33, -1, "float32"),
    ("weight_only_int4", 64, -1, "bfloat16"),
    ("weight_only_int4", 32, 8, "float32"),
    ("weight_only_int4", 33, 11, "float32"),
    ("llm.int8", 24, -1, "float32"),
])
def test_weight_quantize_codes_and_scales_bit_exact(algo, k, group, dtype):
    rw, pw = _both(_rand(k, 40, seed=k) * 3, dtype)
    rq, rs = RF.weight_quantize(rw, algo=algo, group_size=group)
    pq, ps = PF.weight_quantize(pw, algo=algo, group_size=group)
    assert str(pq.dtype) == str(rq.dtype) == "int8"
    assert str(ps.dtype) == str(rs.dtype) == "float32"
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq._data))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs._data))
    rows = (k + 1) // 2 if algo == "weight_only_int4" else k
    assert tuple(pq.shape) == (rows, 40)


@pytest.mark.parametrize("qmax", [127.0, 63.0])
def test_weight_quantize_raw_is_the_serving_rule(qmax):
    import jax.numpy as jnp

    w = _rand(24, 16, seed=3) * 2
    rq, rs = RF.weight_quantize_raw(jnp.asarray(w), qmax)
    pq, ps = PF.weight_quantize_raw(torch.from_numpy(w), qmax)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    assert np.abs(pq.numpy()).max() <= qmax
    if qmax == 127.0:
        from paddle_tpu_torch.ops.quantized import quantize_int8

        q2, s2 = quantize_int8(torch.from_numpy(w))
        assert torch.equal(q2, pq) and torch.equal(s2, ps)


@pytest.mark.parametrize("algo,k,group,out_dtype", [
    ("weight_only_int8", 16, -1, "float32"),
    ("weight_only_int8", 16, -1, None),
    ("weight_only_int4", 33, -1, "float32"),
    ("weight_only_int4", 32, 8, "float32"),
    ("weight_only_int4", 32, -1, "bfloat16"),
])
def test_weight_dequantize(algo, k, group, out_dtype):
    rw, pw = _both(_rand(k, 24, seed=5))
    rq, rs = RF.weight_quantize(rw, algo=algo, group_size=group)
    pq, ps = PF.weight_quantize(pw, algo=algo, group_size=group)
    kw = {} if out_dtype is None else {"out_dtype": out_dtype}
    want = RF.weight_dequantize(rq, rs, algo=algo, k=k, **kw)
    got = PF.weight_dequantize(pq, ps, algo=algo, k=k, **kw)
    assert str(got.dtype) == str(want.dtype) == (out_dtype or "float16")
    np.testing.assert_array_equal(_np(got), _np(want))
    if algo == "weight_only_int4" and k % 2 == 0:
        # the packed rows' default K is 2 * rows
        np.testing.assert_array_equal(
            _np(PF.weight_dequantize(pq, ps, algo=algo, **kw)), _np(got))


def test_weight_quantize_refusals():
    for mod, t in ((RF, paddle.to_tensor(_rand(12, 8))),
                   (PF, pt.to_tensor(_rand(12, 8)))):
        with pytest.raises(ValueError, match="unknown algo"):
            mod.weight_quantize(t, algo="weight_only_int2")
        with pytest.raises(ValueError, match="does not divide"):
            mod.weight_quantize(t, algo="weight_only_int4", group_size=5)
        with pytest.raises(ValueError, match="int4 packing knob"):
            mod.weight_quantize(t, algo="weight_only_int8", group_size=4)
        q, s = mod.weight_quantize(t)
        with pytest.raises(ValueError, match="requires weight_scale"):
            mod.weight_only_linear(t, q)
        with pytest.raises(ValueError, match="unsupported weight_dtype"):
            mod.weight_only_linear(t, q, weight_scale=s,
                                   weight_dtype="int2")
        with pytest.raises(ValueError, match="requires weight_scale"):
            mod.llm_int8_linear(t, q)


def _linear_case(pkg, fn, x, w, b, algo, group):
    """(out, x.grad, bias grad) of fn over the package's tensors."""
    xt = pkg.to_tensor(x, stop_gradient=False)
    q, s = pkg.incubate.nn.functional.weight_quantize(
        pkg.to_tensor(w), algo=algo, group_size=group)
    s.stop_gradient = False
    bt = None if b is None else pkg.to_tensor(b, stop_gradient=False)
    out = fn(xt, q, bt, s)
    wsum = pkg.to_tensor(np.random.RandomState(9).randn(*out.shape)
                         .astype("float32"))
    (out * wsum).sum().backward()
    return out, xt.grad, None if bt is None else bt.grad, s.grad


def _held(fn_name, algo, group, bias, x_shape, outliers=()):
    k = x_shape[-1]
    x = _rand(*x_shape, seed=11)
    for c in outliers:
        x[..., c] *= 20.0
    w = _rand(k, 32, seed=12)
    b = _rand(32, seed=13) if bias else None
    wd = "int4" if algo == "weight_only_int4" else "int8"
    outs = []
    for pkg in (pt, paddle):
        f = getattr(pkg.incubate.nn.functional, fn_name)
        if fn_name == "weight_only_linear":
            call = (lambda xt, q, bt, s, f=f:
                    f(xt, q, bt, weight_scale=s, weight_dtype=wd,
                      group_size=group))
        else:
            call = (lambda xt, q, bt, s, f=f:
                    f(xt, q, bt, weight_scale=s, threshold=6.0))
        outs.append(_linear_case(pkg, call, x, w, b, algo, group))
    (po, pdx, pdb, pds), (ro, rdx, rdb, rds) = outs
    _close(po, ro)
    _close(pdx, rdx)
    assert pdb is None and rdb is None
    assert pds is None and rds is None


@pytest.mark.parametrize("algo,group,bias", [
    ("weight_only_int8", -1, False), ("weight_only_int8", -1, True),
    ("weight_only_int4", -1, False), ("weight_only_int4", -1, True),
    ("weight_only_int4", 8, True),
])
def test_weight_only_linear_and_its_gradient(algo, group, bias):
    _held("weight_only_linear", algo, group, bias, (2, 5, 24))


@pytest.mark.parametrize("x_shape,outliers,bias", [
    ((6, 24), (3,), True), ((6, 24), (), False), ((2, 3, 24), (1, 7), True),
])
def test_llm_int8_linear_and_its_gradient(x_shape, outliers, bias):
    _held("llm_int8_linear", "weight_only_int8", -1, bias, x_shape,
          outliers)


def test_int8_matmul_is_exact_at_k5504():
    rs = np.random.RandomState(14)
    a = rs.randint(-127, 128, (9, 5504)).astype(np.int8)
    b = rs.randint(-127, 128, (5504, 40)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # an f32 sum of these products would round: the sums pass 2^24
    assert np.abs(want).max() > 2 ** 24 or \
        np.abs(a.astype(np.int64)).sum(1).max() * 127 > 2 ** 24
