"""The port's fused LayerNorm (K3-LN, both kinds) against paddle_tpu's.

The `LayerNorm` and `AddLayerNorm` autograd Functions of
`paddle_tpu_torch.ops.fused_norm` (on CPU tensors: the kernels' plain
versions), reached through `layer_norm_raw` / `add_layer_norm_raw`, are
held, forward and backward, against the reference's Pallas kernels run in
interpret mode (`pn.layer_norm_raw`, `pn.add_layer_norm_raw` with
`pn.FORCE_PALLAS = True`, and their `jax.vjp`), and in f32 against the
reference's own `F.layer_norm` / `F.fused_add_layer_norm` compositions.
Inputs come from numpy with a seed: ragged rows (2 x 33), hidden 64 and
80, one row with a large common offset (the kernels' E[x^2] - mean^2
variance), with and without weight and bias, f32 and bf16, and bf16 x
with f32 weight and bias (f32 out: the reference's O2 norm; default out:
the reference's dtype promotion). Tolerances, of each output's largest
|value|: f32 5e-5 (f32 sums in another order); bf16 2^-7 (each side
rounds its f32 result once to bf16: at most one bf16 ulp apart). Then an
f64 gradcheck of both Functions and the `nn.functional` routing.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.ops import pallas_norm as pn

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import fused_norm as fn

TOL = {"float32": 5e-5, "bfloat16": 2 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-5
AFFINE = {"wb": (True, True), "w": (True, False), "none": (False, False)}


@pytest.fixture
def pallas():
    pn.FORCE_PALLAS = True
    yield
    pn.FORCE_PALLAS = None


def _pair(a, dtype, grad=True):
    """The same numpy array as a jax array and a torch tensor in `dtype`
    (both round f32 to bf16 to nearest even)."""
    j = jnp.asarray(a).astype(JDT[dtype])
    t = torch.from_numpy(a).to(TDT[dtype])
    return j, t.requires_grad_(grad)


def _rows(rs, h, offset=8.0):
    """[2, 33, h] normal rows; row (0, 5) carries a large common offset."""
    x = rs.randn(2, 33, h).astype("float32")
    x[0, 5] += offset
    return x


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _vjp(f, args, cots):
    out, pull = jax.vjp(f, *args)
    return out, pull(cots)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 80])
@pytest.mark.parametrize("affine", list(AFFINE))
def test_layer_norm_matches_pallas(pallas, dtype, h, affine):
    rs = np.random.RandomState(h)
    xj, xt = _pair(_rows(rs, h), dtype)
    wj, wt = _pair(rs.randn(h).astype("float32"), dtype)
    bj, bt = _pair(rs.randn(h).astype("float32"), dtype)
    dyj, dyt = _pair(rs.randn(2, 33, h).astype("float32"), dtype, False)
    has_w, has_b = AFFINE[affine]
    params_j = [p for p, on in ((wj, has_w), (bj, has_b)) if on]

    def ref(a, *p):
        it = iter(p)
        return pn.layer_norm_raw(a, next(it) if has_w else None,
                                 next(it) if has_b else None, EPS)

    y, grads = _vjp(ref, (xj, *params_j), dyj)
    yt = fn.layer_norm_raw(xt, wt if has_w else None, bt if has_b else None,
                           EPS)
    yt.backward(dyt)
    assert yt.dtype == TDT[dtype]
    params_t = [p for p, on in ((wt, has_w), (bt, has_b)) if on]
    _close(yt, y, TOL[dtype], "y")
    for got, want, what in zip([xt.grad] + [p.grad for p in params_t],
                               grads, ("dx", "dw", "db")):
        _close(got, want, TOL[dtype], what)


@pytest.mark.parametrize("h", [64, 80])
def test_layer_norm_f32_out_of_bf16_is_the_reference_o2_norm(pallas, h):
    """out_dtype=float32 over bf16 x with f32 w and b equals the
    reference's O2 autocast of layer_norm: x upcast, the f32 kernel, f32
    out; dx flows back to bf16 through the upcast."""
    rs = np.random.RandomState(7 + h)
    xj, xt = _pair(_rows(rs, h), "bfloat16")
    wj, wt = _pair(rs.randn(h).astype("float32"), "float32")
    bj, bt = _pair(rs.randn(h).astype("float32"), "float32")
    dy = rs.randn(2, 33, h).astype("float32")
    y, (dx, dw, db) = _vjp(lambda a, w, b: pn.layer_norm_raw(
        a.astype(jnp.float32), w, b, EPS), (xj, wj, bj), jnp.asarray(dy))
    yt = fn.layer_norm_raw(xt, wt, bt, EPS, out_dtype=torch.float32)
    yt.backward(torch.from_numpy(dy))
    assert yt.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    _close(yt, y, TOL["float32"], "y")
    _close(xt.grad, dx, TOL["bfloat16"], "dx")
    for got, want, what in ((wt.grad, dw, "dw"), (bt.grad, db, "db")):
        _close(got, want, TOL["float32"], what)


def test_layer_norm_mixed_dtypes_promote_as_the_reference(pallas):
    """bf16 x with f32 w and b and no out_dtype: the norm rounds to bf16,
    then promotes to f32, as the reference's `layer_norm_raw` does."""
    rs = np.random.RandomState(21)
    xj, xt = _pair(_rows(rs, 80), "bfloat16")
    wj, wt = _pair(rs.randn(80).astype("float32"), "float32")
    bj, bt = _pair(rs.randn(80).astype("float32"), "float32")
    dy = rs.randn(2, 33, 80).astype("float32")
    y, (dx, dw, db) = _vjp(lambda a, w, b: pn.layer_norm_raw(a, w, b, EPS),
                           (xj, wj, bj), jnp.asarray(dy))
    yt = fn.layer_norm_raw(xt, wt, bt, EPS)
    yt.backward(torch.from_numpy(dy))
    assert yt.dtype == torch.float32
    for got, want, what in ((yt, y, "y"), (xt.grad, dx, "dx"),
                            (wt.grad, dw, "dw"), (bt.grad, db, "db")):
        _close(got, want, TOL["bfloat16"], what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 80])
def test_add_layer_norm_matches_pallas(pallas, dtype, h):
    rs = np.random.RandomState(100 + h)
    xj, xt = _pair(_rows(rs, h), dtype)
    rj, rt = _pair(rs.randn(2, 33, h).astype("float32"), dtype)
    wj, wt = _pair(rs.randn(h).astype("float32"), dtype)
    bj, bt = _pair(rs.randn(h).astype("float32"), dtype)
    dyj, dyt = _pair(rs.randn(2, 33, h).astype("float32"), dtype, False)
    dsj, dst = _pair(rs.randn(2, 33, h).astype("float32"), dtype, False)
    (y, s), grads = _vjp(
        lambda a, r, w, b: pn.add_layer_norm_raw(a, r, w, b, EPS),
        (xj, rj, wj, bj), (dyj, dsj))
    yt, st = fn.add_layer_norm_raw(xt, rt, wt, bt, EPS)
    torch.autograd.backward((yt, st), (dyt, dst))
    assert yt.dtype == st.dtype == TDT[dtype]
    for got, want, what in zip((yt, st, xt.grad, rt.grad, wt.grad, bt.grad),
                               (y, s, *grads),
                               ("y", "s", "dx", "dres", "dw", "db")):
        _close(got, want, TOL[dtype], what)


def _ref_grads(f, arrays, cots):
    """Outputs and input gradients of the reference's nn.functional `f`
    on paddle_tpu tensors (its eager autograd)."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    outs = f(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * paddle.to_tensor(c)).sum() for o, c in zip(outs, cots))
    loss.backward()
    return ([np.asarray(o._data) for o in outs],
            [np.asarray(t.grad._data) for t in ts])


@pytest.mark.parametrize("op", ["layer_norm", "fused_add_layer_norm"])
def test_f32_ops_match_reference_compositions(op):
    """Forward and gradients in f32 against the reference's
    `F.layer_norm` / `F.fused_add_layer_norm` off the kernel (its XLA
    composition, two-pass variance), on the offset rows too."""
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    pn.FORCE_PALLAS = False
    try:
        rs = np.random.RandomState(31)
        x, r = _rows(rs, 80), rs.randn(2, 33, 80).astype("float32")
        w, b = (rs.randn(80).astype("float32") for _ in range(2))
        cots = [rs.randn(2, 33, 80).astype("float32") for _ in range(2)]
        if op == "layer_norm":
            arrays = (x, w, b)
            want, want_g = _ref_grads(
                lambda a, p, q: RF.layer_norm(a, 80, p, q, EPS), arrays,
                cots[:1])
            port = lambda a, p, q: (fn.layer_norm_raw(a, p, q, EPS),)  # noqa
        else:
            arrays = (x, r, w, b)
            want, want_g = _ref_grads(
                lambda a, s, p, q: RF.fused_add_layer_norm(a, s, p, q, EPS),
                arrays, cots)
            port = lambda *t: fn.add_layer_norm_raw(*t, EPS)  # noqa: E731
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        got = port(*ts)
        torch.autograd.backward(got, [torch.from_numpy(c)
                                      for c in cots[:len(got)]])
        for g, wv in zip((*got, *(t.grad for t in ts)), (*want, *want_g)):
            _close(g, wv, TOL["float32"], op)
    finally:
        pn.FORCE_PALLAS = None
        paddle.set_flags(old)


def test_layer_norm_functions_pass_gradcheck():
    """f64 gradcheck of LayerNorm and AddLayerNorm (their plain versions'
    backward against finite differences of their forward)."""
    torch.manual_seed(0)
    x, r = (torch.randn(3, 7, 24, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    w, b = (torch.randn(24, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, p, q: fn.layer_norm_raw(a, p, q, EPS), (x, w, b))
    assert torch.autograd.gradcheck(
        lambda a, s, p, q: fn.add_layer_norm_raw(a, s, p, q, EPS),
        (x, r, w, b))


@pytest.mark.parametrize("fused", [True, False], ids=["flag-on", "flag-off"])
def test_flag_routes_layer_norm(monkeypatch, fused):
    """FLAGS_pallas_fused_ops on: `layer_norm` (one normalized axis) and
    `fused_add_layer_norm` take the fused raw entries; off: the
    compositions, which give the same f32 function. Two normalized axes
    always take the composition."""
    calls = []
    for name in ("layer_norm_raw", "add_layer_norm_raw"):
        real = getattr(fn, name)
        monkeypatch.setattr(fn, name, lambda *a, real=real, name=name,
                            **k: calls.append(name) or real(*a, **k))
    rs = np.random.RandomState(5)
    x, r = (torch.from_numpy(_rows(rs, 80)) for _ in range(2))
    w, b = (torch.from_numpy(rs.randn(80).astype("float32"))
            for _ in range(2))
    old = flag("FLAGS_pallas_fused_ops")
    set_flags({"FLAGS_pallas_fused_ops": fused})
    try:
        y = PF.layer_norm(x, 80, w, b, EPS)
        y2, s = PF.fused_add_layer_norm(x, r, w, b, EPS)
        z = PF.layer_norm(x, (33, 80), None, None, EPS)
    finally:
        set_flags({"FLAGS_pallas_fused_ops": old})
    assert calls == (["layer_norm_raw", "add_layer_norm_raw"] if fused
                     else [])
    ln = torch.nn.functional.layer_norm
    wd, bd = w.double(), b.double()
    for got, want in ((y, ln(x.double(), (80,), wd, bd, EPS)),
                      (y2, ln((x + r).double(), (80,), wd, bd, EPS)),
                      (z, ln(x.double(), (33, 80), eps=EPS))):
        err = (got.double() - want).abs().max() / want.abs().max()
        assert err <= TOL["float32"], err
    torch.testing.assert_close(s, x + r)
