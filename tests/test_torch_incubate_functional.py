"""The port's `incubate.nn.functional` (the fused-op API) held to
paddle_tpu's on the CPU.

Every function of the reference's module except item 3's quantization
five (which raise NotImplementedError naming ROADMAP.md Queue 1 item 3)
on the same seeded inputs: each output within 1e-5 of its largest
|value|, and the gradient of a weighted sum of the outputs in every
floating input the reference differentiates, against the reference's
tape, likewise (the attention and MoE functions in
test_torch_incubate_attention.py). The kernel paths (`fused_rms_norm`,
`fused_layer_norm`, `swiglu`, `fused_rotary_position_embedding`,
`fused_dropout_add`) run the kernels' plain versions here (CPU tensors)
with `FLAGS_pallas_fused_ops` on, as the reference's run its
compositions below its kernels' size gate; dropout compares at p 0 and in eval mode
(the two packages' masks differ by design). The refusals are the
reference's.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.core import device as port_device

ITEM_3 = ("weight_quantize", "weight_quantize_raw", "weight_dequantize",
          "weight_only_linear", "llm_int8_linear")


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
    return np.asarray(t._data) if isinstance(t, paddle.Tensor) \
        else t.numpy()


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [] if out is None else [out]


def _run(pkg, fn, arrays, diff):
    ts = [pkg.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    outs = _flat(fn(pkg, *ts))
    rs = np.random.RandomState(9)
    loss = None
    for o in outs:
        if str(o.dtype).startswith("float"):
            w = pkg.to_tensor(rs.randn(*o.shape).astype(str(o.dtype)))
            term = (o * w).sum()
            loss = term if loss is None else loss + term
    if diff:
        loss.backward()
    return outs, [ts[i].grad for i in diff]


def check(fn, arrays, diff=(), tol=1e-5):
    """fn(pkg, *Tensors) of both packages: outputs and the gradients of
    the inputs at `diff`."""
    (po, pg), (ro, rg) = (_run(pkg, fn, arrays, diff)
                          for pkg in (pt, paddle))
    assert len(po) == len(ro)
    for a, b in zip(po + pg, ro + rg):
        assert str(a.dtype) == str(b.dtype)
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(np.abs(b).max(), 1e-30))


def _f(pkg):
    return PF if pkg is pt else RF


def _rand(*shape, seed=0, lo=None):
    a = np.random.RandomState(seed + sum(shape)).randn(*shape)
    return (np.abs(a) + lo if lo is not None else a).astype("float32")


def test_every_reference_name_exists():
    for name in RF.__all__ + list(ITEM_3) + ["memory_efficient_attention",
                                             "fused_linear_cross_entropy"]:
        assert callable(getattr(PF, name)), name
    assert PF.__all__ == RF.__all__


@pytest.mark.parametrize("name", ITEM_3)
def test_quantization_functions_name_item_3(name):
    with pytest.raises(NotImplementedError, match="item 3"):
        getattr(PF, name)(pt.to_tensor(np.ones((4, 4), "float32")))


# --------------------------------------------------------------- kernel paths
@pytest.mark.parametrize("residual,bias", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_fused_rms_norm(residual, bias):
    def fn(pkg, x, r, w, b):
        return _f(pkg).fused_rms_norm(x, w, b if bias else None, 1e-6,
                                      residual=r if residual else None)

    check(fn, [_rand(3, 5, 16), _rand(3, 5, 16, seed=1), _rand(16, seed=2),
               _rand(16, seed=3)],
          diff=(0, 1, 2) + ((3,) if bias else ()) if residual
          else (0, 2) + ((3,) if bias else ()))


@pytest.mark.parametrize("case", ["last", "axis1", "residual"])
def test_fused_layer_norm(case):
    def fn(pkg, x, r, w, b):
        F = _f(pkg)
        if case == "residual":
            return F.fused_layer_norm(x, w, b, 1e-5, residual=r)
        if case == "axis1":
            w2, b2 = (pkg.reshape(pkg.tile(t, [5]), [5, 16]) for t in (w, b))
            return F.fused_layer_norm(x, w2, b2, 1e-5, begin_norm_axis=1)
        return F.fused_layer_norm(x, w, b, 1e-5)

    check(fn, [_rand(3, 5, 16), _rand(3, 5, 16, seed=1), _rand(16, seed=2),
               _rand(16, seed=3)],
          diff=(0, 1, 2, 3) if case == "residual" else (0, 2, 3))


@pytest.mark.parametrize("two", [True, False])
def test_swiglu(two):
    check(lambda pkg, a, b: _f(pkg).swiglu(a, b) if two
          else _f(pkg).swiglu(a), [_rand(4, 12), _rand(4, 12, seed=1)],
          diff=(0, 1) if two else (0,))


@pytest.mark.parametrize("parts", ["q", "qk", "qkv", "gqa"])
def test_fused_rotary_position_embedding(parts):
    d = 8
    ang = np.arange(6)[:, None] * np.linspace(0.1, 1, d // 2)[None]
    ang = np.concatenate([ang, ang], -1)[None, :, None, :]
    cos, sin = np.cos(ang).astype("float32"), np.sin(ang).astype("float32")
    kv = 1 if parts == "gqa" else 2

    def fn(pkg, q, k, v, c, s):
        F = _f(pkg)
        if parts == "q":
            return F.fused_rotary_position_embedding(q, sin=s, cos=c)
        if parts == "qkv":
            return F.fused_rotary_position_embedding(q, k, v, sin=s, cos=c)
        return F.fused_rotary_position_embedding(q, k, sin=s, cos=c)

    check(fn, [_rand(2, 6, 2, d), _rand(2, 6, kv, d, seed=1),
               _rand(2, 6, kv, d, seed=2), cos, sin],
          diff=(0,) if parts == "q" else (0, 1))


def test_rotary_refusals():
    q = np.ones((1, 2, 1, 4), "float32")
    for pkg in (pt, paddle):
        F, t = _f(pkg), pkg.to_tensor(q)
        with pytest.raises(NotImplementedError):
            F.fused_rotary_position_embedding(t, sin=t, cos=t,
                                              use_neox_rotary_style=False)
        with pytest.raises(NotImplementedError):
            F.fused_rotary_position_embedding(t, sin=t, cos=t,
                                              position_ids=t)
        with pytest.raises(ValueError):
            F.fused_rotary_position_embedding(t, sin=t)


@pytest.mark.parametrize("p,training", [(0.0, True), (0.5, False)])
def test_fused_dropout_add(p, training):
    check(lambda pkg, x, y: _f(pkg).fused_dropout_add(x, y, p=p,
                                                      training=training),
          [_rand(4, 6), _rand(4, 6, seed=1)], diff=(0, 1))


# --------------------------------------------------------------- compositions
@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear(transpose):
    w = _rand(6, 5) if transpose else _rand(5, 6)
    check(lambda pkg, x, w, b: _f(pkg).fused_linear(x, w, b, transpose),
          [_rand(3, 5), w, _rand(6, seed=2)], diff=(0, 1, 2))


@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_fused_bias_act(act):
    check(lambda pkg, x, b: _f(pkg).fused_bias_act(x, b, act),
          [_rand(3, 7), _rand(7, seed=1)], diff=(0, 1))


def test_fused_multi_head_attention_refuses():
    for F in (PF, RF):
        with pytest.raises(NotImplementedError):
            F.fused_multi_head_attention()


@pytest.mark.parametrize("tx,ty,bias", [(False, False, True),
                                        (True, False, True),
                                        (False, True, False)])
def test_fused_matmul_bias(tx, ty, bias):
    x = _rand(5, 3) if tx else _rand(3, 5)
    y = _rand(4, 5, seed=1) if ty else _rand(5, 4, seed=1)
    check(lambda pkg, x, y, b: _f(pkg).fused_matmul_bias(
        x, y, b if bias else None, tx, ty), [x, y, _rand(4, seed=2)],
        diff=(0, 1, 2) if bias else (0, 1))


@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
def test_fused_linear_activation(act):
    check(lambda pkg, x, y, b: _f(pkg).fused_linear_activation(
        x, y, b, activation=act), [_rand(3, 5), _rand(5, 4, seed=1),
                                   _rand(4, seed=2)], diff=(0, 1, 2))


def test_fused_bias_dropout_residual_layer_norm():
    check(lambda pkg, x, r, b, s, lb:
          _f(pkg).fused_bias_dropout_residual_layer_norm(
              x, r, b, s, lb, dropout_rate=0.0),
          [_rand(2, 3, 8), _rand(2, 3, 8, seed=1), _rand(8, seed=2),
           _rand(8, seed=3), _rand(8, seed=4)], diff=(0, 1, 2, 3, 4))


@pytest.mark.parametrize("pre,act", [(True, "relu"), (False, "gelu")])
def test_fused_feedforward(pre, act):
    check(lambda pkg, x, w1, w2, b1, b2, s1, c1, s2, c2:
          _f(pkg).fused_feedforward(
              x, w1, w2, b1, b2, s1, c1, s2, c2, dropout1_rate=0.0,
              dropout2_rate=0.0, activation=act, pre_layer_norm=pre),
          [_rand(2, 3, 8), _rand(8, 16, seed=1), _rand(16, 8, seed=2),
           _rand(16, seed=3), _rand(8, seed=4), _rand(8, seed=5),
           _rand(8, seed=6), _rand(8, seed=7), _rand(8, seed=8)],
          diff=(0, 1, 2, 3, 4) + ((5, 6) if pre else (7, 8)))
