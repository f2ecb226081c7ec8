"""The port's `incubate` package root and `incubate.autograd` held to
paddle_tpu's on the CPU (ROADMAP.md Queue 1 item 1f).

`identity_loss`, the masked softmaxes (values and gradients against the
reference's tape), `LookAhead` and `ModelAverage` (the same updates as
the reference's wrappers over bit-identical AdamW / SGD steps; their
state on the parameters' device; the reference's own `ModelAverage` case
of tests/test_param_audit_fixes.py; a `LookAhead` step captured by
`jit.to_static` equal to the eager one), `incubate.autograd`'s jvp, vjp,
grad, Jacobian and Hessian against the reference's (with the reference's
cases of tests/test_double_grad.py), and every public name of the
reference's `incubate` present.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device


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


def _close(got, want, tol=1e-6):
    assert str(got.dtype) == str(want.dtype)
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_every_reference_name_exists():
    import paddle_tpu.incubate.autograd as rag

    for name in paddle.incubate.__all__:
        assert hasattr(pt.incubate, name), name
    for name in ("jvp", "vjp", "grad", "Jacobian", "Hessian"):
        assert hasattr(rag, name) and hasattr(pt.incubate.autograd, name)
    with pytest.raises(NotImplementedError, match="Distributed"):
        pt.incubate.distributed.models


@pytest.mark.parametrize("reduction", ["none", "sum", "mean", 0, 1])
def test_identity_loss(reduction):
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    outs = []
    for pkg in (pt, paddle):
        t = pkg.to_tensor(x, stop_gradient=False)
        out = pkg.incubate.identity_loss(t, reduction)
        (out * out).sum().backward()
        outs.append((out, t.grad))
    for a, b in zip(*outs):
        _close(a, b)


@pytest.mark.parametrize("fn", ["softmax_mask_fuse",
                                "softmax_mask_fuse_upper_triangle"])
def test_masked_softmax(fn):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 5, 5).astype("float32")
    mask = np.where(rs.rand(2, 1, 5, 5) > 0.3, 0.0, -1e4).astype("float32")
    w = rs.randn(2, 3, 5, 5).astype("float32")
    outs = []
    for pkg in (pt, paddle):
        t = pkg.to_tensor(x, stop_gradient=False)
        args = (t, pkg.to_tensor(mask)) if fn == "softmax_mask_fuse" \
            else (t,)
        out = getattr(pkg.incubate, fn)(*args)
        (out * pkg.to_tensor(w)).sum().backward()
        outs.append((out, t.grad))
    for a, b in zip(*outs):
        _close(a, b, 1e-5)


def _params(pkg, seed=0):
    rs = np.random.RandomState(seed)
    return [pkg.to_tensor(rs.randn(*s).astype("float32"),
                          stop_gradient=False) for s in ((4, 3), (3,))]


def _grads(seed, step):
    rs = np.random.RandomState(100 * seed + step)
    return [rs.randn(4, 3).astype("float32"), rs.randn(3).astype("float32")]


@pytest.mark.parametrize("k,alpha", [(2, 0.5), (3, 0.8)])
def test_lookahead_matches_reference(k, alpha):
    """Seven steps of LookAhead over AdamW (bit-identical between the
    packages) from the same weights and gradients: the fast weights equal
    the reference's."""
    final = []
    for pkg in (pt, paddle):
        ps = _params(pkg)
        inner = pkg.optimizer.AdamW(learning_rate=0.05, parameters=ps)
        la = pkg.incubate.LookAhead(inner, alpha=alpha, k=k)
        for step in range(7):
            for p, g in zip(ps, _grads(0, step)):
                (p * pkg.to_tensor(g)).sum().backward()
            la.step()
            la.clear_grad()
        final.append(ps)
    for a, b in zip(*final):
        _close(a, b, 1e-6)


def test_model_average_matches_reference():
    """A window of 3 over 6 updates (the rescaling past the window), the
    means swapped in by apply() and the weights back after."""
    vals = [1.0, 2.0, 3.0, 40.0, -5.0, 7.0]
    res = []
    for pkg in (pt, paddle):
        p = pkg.to_tensor(np.zeros(2, "float32"), stop_gradient=False)
        ma = pkg.incubate.ModelAverage(0.5, parameters=[p],
                                       min_average_window=2,
                                       max_average_window=3)
        seen = []
        for v in vals:
            with pkg.no_grad():
                p.set_value(np.full(2, v, "float32")) if pkg is pt \
                    else p._assign_raw(np.full(2, v, "float32"))
            ma.step()
            with ma.apply():
                seen.append(_np(p).copy())
        res.append((seen, _np(p).copy()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-6)
    np.testing.assert_array_equal(res[0][1], res[1][1])


def test_reference_model_average_case_on_the_port():
    """tests/test_param_audit_fixes.py:331 on the port: the window capped
    at 3, the first value's weight decayed."""
    p = pt.to_tensor(np.zeros(1, "float32"))
    ma = pt.incubate.ModelAverage(1.0, parameters=[p], min_average_window=2,
                                  max_average_window=3)
    for v in [1.0, 2.0, 3.0, 40.0]:
        p.set_value(np.full(1, v, "float32"))
        ma.step()
    with ma.apply():
        assert float(p.numpy()[0]) > (1 + 2 + 3 + 40) / 4 - 5
    assert float(p.numpy()[0]) == 40.0


def test_wrappers_keep_state_on_the_parameters_device_and_capture():
    """LookAhead's slow weights and step counter, ModelAverage's sums and
    counts are tensors on the parameters' device; a step of each under
    jit.to_static gives the eager step's weights."""
    from paddle_tpu_torch import jit

    runs = []
    for static in (False, True):
        ps = _params(pt, 1)
        inner = pt.optimizer.SGD(learning_rate=0.1, parameters=ps)
        la = pt.incubate.LookAhead(inner, alpha=0.5, k=2)
        ma = pt.incubate.ModelAverage(1.0, parameters=ps,
                                      min_average_window=2,
                                      max_average_window=3)
        g = [pt.to_tensor(a) for a in _grads(1, 0)]

        def step():
            for p, gi in zip(ps, g):
                (p * gi).sum().backward()
            la.step()
            la.clear_grad()
            ma.step()
            return ps[0] * 1.0

        fn = jit.to_static(step) if static else step
        for _ in range(6):
            fn()
        runs.append([p.numpy().copy() for p in ps])
        assert la._step_t.device == ps[0]._data.device
        assert all(t.device == ps[0]._data.device for t in la._slow)
        assert ma._count.device == ps[0]._data.device
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, rtol=1e-6)


# -------------------------------------------------------- incubate.autograd
def _fns(pkg):
    return {"square_sum": lambda t: (t * t).sum(),
            "cube": lambda t: t * t * t,
            "two_in": lambda a, b: (pkg.sin(a) * b).sum()}


@pytest.mark.parametrize("name", ["square_sum", "cube", "two_in"])
def test_jvp_vjp_grad_match_reference(name):
    import paddle_tpu.incubate.autograd as rag

    rs = np.random.RandomState(2)
    arrays = [rs.randn(3).astype("float32")] * (2 if name == "two_in"
                                                 else 1)
    arrays = [a + i for i, a in enumerate(arrays)]
    tang = [rs.randn(3).astype("float32") for _ in arrays]
    out = {}
    for pkg, ag in ((pt, pt.incubate.autograd), (paddle, rag)):
        fn = _fns(pkg)[name]
        xs = [pkg.to_tensor(a) for a in arrays]
        xs = xs if len(xs) > 1 else xs[0]
        v = [pkg.to_tensor(t) for t in tang]
        v = v if len(v) > 1 else v[0]
        out[pkg] = (ag.jvp(fn, xs, v), ag.jvp(fn, xs), ag.vjp(fn, xs),
                    ag.grad(fn, xs) if name != "cube" else None)
    mine, theirs = out[pt], out[paddle]
    for a, b in zip(mine[:3], theirs[:3]):
        for x, y in zip(a, b):
            for xi, yi in zip(x if isinstance(x, list) else [x],
                              y if isinstance(y, list) else [y]):
                _close(xi, yi, 1e-5)
    if mine[3] is not None:
        for xi, yi in zip(mine[3] if isinstance(mine[3], list)
                          else [mine[3]],
                          theirs[3] if isinstance(theirs[3], list)
                          else [theirs[3]]):
            _close(xi, yi, 1e-5)


@pytest.mark.parametrize("name", ["square_sum", "cube", "two_in"])
def test_jacobian_hessian_match_reference(name):
    import paddle_tpu.incubate.autograd as rag

    rs = np.random.RandomState(3)
    arrays = [rs.randn(3).astype("float32") + i
              for i in range(2 if name == "two_in" else 1)]
    res = {}
    for pkg, ag in ((pt, pt.incubate.autograd), (paddle, rag)):
        fn = _fns(pkg)[name]
        xs = [pkg.to_tensor(a) for a in arrays]
        xs = xs if len(xs) > 1 else xs[0]
        j = ag.Jacobian(fn, xs)
        h = ag.Hessian(fn, xs) if name != "cube" else None
        res[pkg] = (j[:], tuple(j.shape), None if h is None else h[:])
    (ja, sa, ha), (jb, sb, hb) = res[pt], res[paddle]
    assert sa == sb
    for x, y in zip(ja if isinstance(ja, tuple) else [ja],
                    jb if isinstance(jb, tuple) else [jb]):
        _close(x, y, 1e-5)
    if ha is not None:
        flat = lambda h: [t for row in h for t in (  # noqa: E731
            row if isinstance(row, tuple) else [row])] \
            if isinstance(h, tuple) else [h]
        for x, y in zip(flat(ha), flat(hb)):
            _close(x, y, 1e-5)


def test_reference_incubate_autograd_cases_on_the_port():
    """tests/test_double_grad.py TestIncubateAutograd on the port."""
    ag = pt.incubate.autograd
    x = pt.to_tensor(np.array([1.0, 2.0], "float32"))
    _, tang = ag.jvp(lambda t: (t ** 2).sum(), x,
                     v=pt.to_tensor(np.array([1.0, 0.0], "float32")))
    np.testing.assert_allclose(float(tang.numpy()), 2.0)
    _, g = ag.vjp(lambda t: (t ** 2).sum(), x)
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    j = ag.Jacobian(lambda t: t ** 2, x)
    np.testing.assert_allclose(j[:].numpy(), np.diag([2.0, 4.0]))
    assert isinstance(j[:], pt.Tensor) and torch.is_tensor(j[:]._data)
