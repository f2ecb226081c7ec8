"""The port's fused RMSNorm, rotary and SwiGLU (K3, K4, K5) against
paddle_tpu's.

Each op of `paddle_tpu_torch.ops.fused_norm` (the autograd Function
behind each raw entry, on CPU tensors: the kernels' plain versions) is
held, forward and backward, against the reference's Pallas kernels run in
interpret mode (`rms_norm_raw`, `add_rms_norm_raw`, `rope_qk_raw`,
`swiglu_raw` and their `jax.vjp`), and in f32 against the reference's XLA
compositions as well. Inputs come from numpy with a seed: ragged rows
(2 x 33), hidden 64 and 80, head_dim 16, and random rope tables (the
backward reads the partner index's sin, which equals "negate sin" only
for tables whose halves repeat). Tolerances, of each output's largest
|value|: f32 5e-5 (f32 sums in another order); bf16 2^-7 (each side
rounds its f32 result once to bf16, so they differ by at most one bf16
ulp). The `nn.functional` routing is checked too: the flag picks the
fused op or the composition, and GQA shapes never reach K4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (x64 and the package's jax setup)
from paddle_tpu.ops import pallas_norm as pn

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import fused_norm as fn

TOL = {"float32": 5e-5, "bfloat16": 2 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-6


def _pair(a, dtype, grad=True):
    """The same numpy array as a jax array and a torch tensor in `dtype`
    (both round f32 to bf16 to nearest even)."""
    j = jnp.asarray(a).astype(JDT[dtype])
    t = torch.from_numpy(a).to(TDT[dtype])
    return j, t.requires_grad_(grad)


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
def test_rms_norm_matches_pallas(dtype, h):
    rs = np.random.RandomState(h)
    xj, xt = _pair(rs.randn(2, 33, h).astype("float32"), dtype)
    wj, wt = _pair(rs.randn(h).astype("float32"), dtype)
    dyj, dyt = _pair(rs.randn(2, 33, h).astype("float32"), dtype, False)
    y, (dx, dw) = _vjp(lambda a, b: pn.rms_norm_raw(a, b, EPS), (xj, wj),
                       dyj)
    yt = fn.rms_norm_raw(xt, wt, EPS)
    yt.backward(dyt)
    assert yt.dtype == TDT[dtype]
    for got, want, what in ((yt, y, "y"), (xt.grad, dx, "dx"),
                            (wt.grad, dw, "dw")):
        _close(got, want, TOL[dtype], what)


@pytest.mark.parametrize("h", [64, 80])
def test_rms_norm_f32_out_of_bf16_is_the_reference_o2_norm(h):
    """out_dtype=float32 over bf16 x and w equals the reference's O2
    autocast of rms_norm: x and w upcast, the f32 kernel, f32 out; the
    gradients flow back to bf16 through the upcast."""
    rs = np.random.RandomState(7 + h)
    xj, xt = _pair(rs.randn(2, 33, h).astype("float32"), "bfloat16")
    wj, wt = _pair(rs.randn(h).astype("float32"), "bfloat16")
    dy = rs.randn(2, 33, h).astype("float32")
    y, (dx, dw) = _vjp(lambda a, b: pn.rms_norm_raw(
        a.astype(jnp.float32), b.astype(jnp.float32), EPS), (xj, wj),
        jnp.asarray(dy))
    yt = fn.rms_norm_raw(xt, wt, EPS, out_dtype=torch.float32)
    yt.backward(torch.from_numpy(dy))
    assert yt.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    _close(yt, y, TOL["float32"], "y")
    for got, want, what in ((xt.grad, dx, "dx"), (wt.grad, dw, "dw")):
        _close(got, want, TOL["bfloat16"], what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 80])
def test_add_rms_norm_matches_pallas(dtype, h):
    rs = np.random.RandomState(100 + h)
    xj, xt = _pair(rs.randn(2, 33, h).astype("float32"), dtype)
    rj, rt = _pair(rs.randn(2, 33, h).astype("float32"), dtype)
    wj, wt = _pair(rs.randn(h).astype("float32"), dtype)
    dyj, dyt = _pair(rs.randn(2, 33, h).astype("float32"), dtype, False)
    dsj, dst = _pair(rs.randn(2, 33, h).astype("float32"), dtype, False)
    (y, s), (dx, dr, dw) = _vjp(
        lambda a, r, b: pn.add_rms_norm_raw(a, r, b, EPS), (xj, rj, wj),
        (dyj, dsj))
    yt, st = fn.add_rms_norm_raw(xt, rt, wt, EPS)
    torch.autograd.backward((yt, st), (dyt, dst))
    for got, want, what in ((yt, y, "y"), (st, s, "s"), (xt.grad, dx, "dx"),
                            (rt.grad, dr, "dres"), (wt.grad, dw, "dw")):
        _close(got, want, TOL[dtype], what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_qk_matches_pallas(dtype):
    rs = np.random.RandomState(3)
    shape = (2, 33, 4, 16)
    qj, qt = _pair(rs.randn(*shape).astype("float32"), dtype)
    kj, kt = _pair(rs.randn(*shape).astype("float32"), dtype)
    cj, ct = _pair(rs.randn(1, 33, 1, 16).astype("float32"), dtype, False)
    sj, st = _pair(rs.randn(1, 33, 1, 16).astype("float32"), dtype, False)
    dqj, dqt = _pair(rs.randn(*shape).astype("float32"), dtype, False)
    dkj, dkt = _pair(rs.randn(*shape).astype("float32"), dtype, False)
    (qo, ko), (dq, dk) = _vjp(lambda a, b: pn.rope_qk_raw(a, b, cj, sj),
                              (qj, kj), (dqj, dkj))
    qot, kot = fn.rope_qk_raw(qt, kt, ct, st)
    torch.autograd.backward((qot, kot), (dqt, dkt))
    for got, want, what in ((qot, qo, "qo"), (kot, ko, "ko"),
                            (qt.grad, dq, "dq"), (kt.grad, dk, "dk")):
        _close(got, want, TOL[dtype], what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cols", [80, 128])
def test_swiglu_matches_pallas(dtype, cols):
    rs = np.random.RandomState(cols)
    gj, gt = _pair(rs.randn(2, 33, cols).astype("float32"), dtype)
    uj, ut = _pair(rs.randn(2, 33, cols).astype("float32"), dtype)
    doj, dot = _pair(rs.randn(2, 33, cols).astype("float32"), dtype, False)
    o, (dg, du) = _vjp(pn.swiglu_raw, (gj, uj), doj)
    ot = fn.swiglu_raw(gt, ut)
    ot.backward(dot)
    for got, want, what in ((ot, o, "o"), (gt.grad, dg, "dg"),
                            (ut.grad, du, "du")):
        _close(got, want, TOL[dtype], what)


def _xla_rms(x, w):
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), -1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + EPS)).astype(x.dtype) * w


def _xla_rot(a, c, s):
    a1, a2 = jnp.split(a, 2, axis=-1)
    return a * c + jnp.concatenate([-a2, a1], -1) * s


@pytest.mark.parametrize("op", ["rms", "add_rms", "rope", "swiglu"])
def test_f32_ops_match_xla_compositions(op):
    """Forward and gradients of each op against `jax.vjp` of the
    reference's XLA composition of the same function."""
    rs = np.random.RandomState(11)
    a = [rs.randn(2, 33, 4, 16).astype("float32") for _ in range(4)] \
        if op == "rope" else [rs.randn(2, 33, 80).astype("float32")
                              for _ in range(4)]
    w = rs.randn(80).astype("float32")
    tabs = [rs.randn(1, 33, 1, 16).astype("float32") for _ in range(2)]
    if op == "rms":
        f_ref, inputs, f_port = _xla_rms, (a[0], w), \
            lambda x, b: fn.rms_norm_raw(x, b, EPS)
    elif op == "add_rms":
        def f_ref(x, r, b):
            s = x + r
            return _xla_rms(s, b), s
        inputs, f_port = (a[0], a[1], w), \
            lambda x, r, b: fn.add_rms_norm_raw(x, r, b, EPS)
    elif op == "rope":
        def f_ref(q, k):
            return _xla_rot(q, *tabs), _xla_rot(k, *tabs)
        inputs = (a[0], a[1])
        tt = [torch.from_numpy(t) for t in tabs]

        def f_port(q, k):
            return fn.rope_qk_raw(q, k, *tt)
    else:
        f_ref, inputs, f_port = (lambda g, u: jax.nn.silu(g) * u,
                                 (a[0], a[1]), fn.swiglu_raw)
    multi = op in ("add_rms", "rope")
    cots = (a[2], a[3]) if multi else a[2]
    want, want_g = _vjp(f_ref, tuple(jnp.asarray(x) for x in inputs),
                        tuple(jnp.asarray(c) for c in cots) if multi
                        else jnp.asarray(cots))
    targs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = f_port(*targs)
    got, want = (got, want) if multi else ((got,), (want,))
    torch.autograd.backward(got, [torch.from_numpy(c) for c in
                                  (cots if multi else (cots,))])
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, TOL["float32"], f"out {i}")
    for i, (t, wg) in enumerate(zip(targs, want_g)):
        _close(t.grad, wg, TOL["float32"], f"grad {i}")


def test_backward_formulas_pass_gradcheck():
    """The autograd Functions' backwards (the plain versions of the
    backward kernels) are the derivatives of their forwards, in f64."""
    rs = np.random.RandomState(5)

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape)).requires_grad_()

    x, r, w = t(3, 10), t(3, 10), t(10)
    assert torch.autograd.gradcheck(
        lambda a, b: fn.RMSNorm.apply(a, b, EPS, None), (x, w))
    assert torch.autograd.gradcheck(
        lambda a, c, b: fn.AddRMSNorm.apply(a, c, b, EPS, None), (x, r, w))
    q, k = t(1, 5, 2, 6), t(1, 5, 2, 6)
    cos, sin = torch.from_numpy(rs.randn(5, 6)), torch.from_numpy(
        rs.randn(5, 6))
    assert torch.autograd.gradcheck(
        lambda a, b: fn.RopeQK.apply(a, b, cos, sin), (q, k))
    assert torch.autograd.gradcheck(fn.SwiGLU.apply, (t(3, 7), t(3, 7)))


@pytest.fixture
def port_flag():
    old = flag("FLAGS_pallas_fused_ops")
    yield
    set_flags({"FLAGS_pallas_fused_ops": old})


def test_functional_routing_follows_the_flag(port_flag, monkeypatch):
    """Flag on: each functional op calls its fused op, rotary only when Q
    and K have one shape. Flag off: none is called, and the compositions
    give the fused ops' values."""
    called = []
    for name in ("rms_norm_raw", "add_rms_norm_raw", "rope_qk_raw",
                 "swiglu_raw"):
        real = getattr(fn, name)

        def spy(*a, _real=real, _name=name, **kw):
            called.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(fn, name, spy)
    rs = np.random.RandomState(9)
    x, r, g = (torch.from_numpy(rs.randn(2, 5, 16).astype("float32"))
               for _ in range(3))
    w = torch.from_numpy(rs.randn(16).astype("float32"))
    q = torch.from_numpy(rs.randn(2, 5, 4, 8).astype("float32"))
    k_gqa = q[:, :, :2].contiguous()
    cos, sin = (torch.from_numpy(rs.randn(1, 5, 1, 8).astype("float32"))
                for _ in range(2))
    out = {}
    for on in (True, False):
        set_flags({"FLAGS_pallas_fused_ops": on})
        called.clear()
        out[on] = (PF.rms_norm(x, w), *PF.fused_add_rms_norm(x, r, w),
                   *PF.rotary_position_embedding(q, q, cos, sin),
                   PF.swiglu(g, r))
        gqa = PF.rotary_position_embedding(q, k_gqa, cos, sin)
        assert called == (["rms_norm_raw", "add_rms_norm_raw",
                           "rope_qk_raw", "swiglu_raw"] if on else [])
        assert gqa[1].shape == k_gqa.shape
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the reference's other forms: one-operand swiglu (gate and up halves
    # of one tensor) and rotary of q alone take the composition
    torch.testing.assert_close(PF.swiglu(torch.cat([g, r], -1)),
                               out[False][-1])
    qo, ko = PF.rotary_position_embedding(q, None, cos, sin)
    assert ko is None
    torch.testing.assert_close(qo, out[False][3])
