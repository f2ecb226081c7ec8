"""The port's autograd: the contracts of tests/test_autograd.py and
tests/test_double_grad.py on `paddle_tpu_torch`, plus PyLayer, hooks,
grad mode, `jacobian`, `hessian` and `saved_tensors_hooks` (CPU).

Numbers come from closed forms (as the reference's tests use jax.grad or
hand derivations); `jacobian` and `hessian` are held to paddle_tpu's
(jax transforms) on the same function and inputs.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch import autograd
from paddle_tpu_torch.core import device as port_device


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = port_device._current
    paddle.set_device("cpu")
    yield
    port_device._current = prev


def t(x, sg=False):
    return paddle.to_tensor(np.asarray(x, dtype=np.float32),
                            stop_gradient=sg)


# ------------------------------------------ tests/test_autograd.py contracts
def test_scalar_backward():
    x = t([1.0, 2.0, 3.0])
    paddle.sum(x * x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0, 6.0])


def test_reused_input_accumulates():
    w_np = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    w = t(w_np)
    paddle.sum(paddle.matmul(w, w)).backward()
    ones = np.ones((2, 2), np.float32)
    np.testing.assert_allclose(w.grad.numpy(), ones @ w_np.T + w_np.T @ ones)


def test_grad_accumulation_across_backwards():
    x = t([2.0])
    (x * 3.0).backward()
    (x * 4.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), [7.0])


def test_chain_and_branching():
    rs = np.random.RandomState(0)
    a_np, b_np = rs.randn(4).astype(np.float32), rs.randn(4).astype(
        np.float32)
    a, b = t(a_np), t(b_np)
    c = a * b
    d = paddle.sin(c) + c
    paddle.sum(d * d).backward()
    cn = a_np * b_np
    dn = np.sin(cn) + cn
    gc = 2 * dn * (np.cos(cn) + 1)
    np.testing.assert_allclose(a.grad.numpy(), gc * b_np, rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), gc * a_np, rtol=1e-5)


def test_stop_gradient_blocks():
    x, y = t([1.0, 2.0]), t([3.0, 4.0], sg=True)
    paddle.sum(x * y).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 4.0])
    assert y.grad is None


def test_detach_cuts_graph():
    x = t([1.0, 2.0])
    y = (x * 2.0).detach()
    assert y.stop_gradient
    paddle.sum(x * 3.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])


def test_no_grad_context():
    x = t([1.0])
    with paddle.no_grad():
        y = x * 2.0
    assert y._node is None and y.stop_gradient
    assert (x * 2.0)._node is not None


def test_non_scalar_backward_requires_grad_tensor():
    x = t([1.0, 2.0])
    y = x * 2.0
    with pytest.raises(RuntimeError):
        y.backward()
    y.backward(paddle.to_tensor(np.ones(2, np.float32)))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


def test_retain_graph():
    x = t([3.0])
    loss = paddle.sum(x * x)
    loss.backward(retain_graph=True)
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0])
    with pytest.raises(RuntimeError):
        loss.backward()


def test_backward_twice_without_retain_raises():
    x = t([3.0])
    loss = paddle.sum(x * x)
    loss.backward()
    with pytest.raises(RuntimeError):
        loss.backward()


def test_hook_scales_grad():
    x = t([1.0, 2.0])
    x.register_hook(lambda g: g * 2.0)
    paddle.sum(x * 3.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])


def test_hook_remove():
    x = t([1.0])
    h = x.register_hook(lambda g: g * 100.0)
    h.remove()
    paddle.sum(x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0])


def test_paddle_grad_api():
    x = t([2.0])
    (g,) = paddle.grad(x * x * x, x, retain_graph=False)
    np.testing.assert_allclose(g.numpy(), [12.0])
    assert x.grad is None


def test_paddle_grad_unused():
    x, z = t([2.0]), t([1.0])
    with pytest.raises(RuntimeError):
        paddle.grad(x * 2.0, [x, z])
    gx, gz = paddle.grad(paddle.sum(x * 2.0), [x, z], allow_unused=True)
    np.testing.assert_allclose(gx.numpy(), [2.0])
    assert gz is None


def test_retain_grads_on_intermediate():
    x = t([1.0, 2.0])
    y = x * 2.0
    y.retain_grads()
    paddle.sum(y * 3.0).backward()
    np.testing.assert_allclose(y.grad.numpy(), [3.0, 3.0])


def test_integer_inputs_not_differentiated():
    idx = paddle.to_tensor(np.array([0, 1], np.int64))
    w = t(np.random.randn(4, 3).astype(np.float32))
    paddle.sum(paddle.gather(w, idx)).backward()
    assert w.grad is not None and w.grad.shape == [4, 3]


def test_clear_grad():
    x = t([1.0])
    paddle.sum(x * 2.0).backward()
    x.clear_grad()
    assert x.grad is None


def test_multi_output_op_backward():
    x = t([3.0, 1.0, 2.0])
    vals, _ = paddle.topk(x, 2)
    paddle.sum(vals).backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 0.0, 1.0])


def test_broadcast_grad_reduces():
    a, b = t(np.ones((3, 4))), t(np.ones((4,)))
    paddle.sum(a + b).backward()
    np.testing.assert_allclose(b.grad.numpy(), [3.0] * 4)


# ------------------------------------- tests/test_double_grad.py contracts
def test_second_derivative():
    x = t([2.0, 3.0])
    (g,) = paddle.grad((x ** 3).sum(), x, create_graph=True)
    assert g._node is not None, "grad must be on the tape"
    np.testing.assert_allclose(g.numpy(), [12.0, 27.0])
    (gg,) = paddle.grad(g.sum(), x)
    np.testing.assert_allclose(gg.numpy(), [12.0, 18.0])


def test_third_derivative():
    x = t([2.0])
    (g1,) = paddle.grad((x ** 4).sum(), x, create_graph=True)
    (g2,) = paddle.grad(g1.sum(), x, create_graph=True)
    (g3,) = paddle.grad(g2.sum(), x)
    np.testing.assert_allclose(g3.numpy(), [48.0])


def test_grad_does_not_pollute_other_leaves():
    x, w = t([[1.0, 2.0]]), t([[0.5], [1.5]])
    paddle.grad(paddle.matmul(x, w).sum(), x, create_graph=True)
    assert w.grad is None


def test_gradient_penalty_pattern():
    x, w = t([[1.0, 2.0]]), t([[0.5], [1.5]])
    (gx,) = paddle.grad(paddle.matmul(x, w).sum(), x, create_graph=True)
    (((gx ** 2).sum() - 1.0) ** 2).backward()
    wv = w.numpy().ravel()
    expect = (2 * (np.sum(wv ** 2) - 1) * 2 * wv).reshape(2, 1)
    np.testing.assert_allclose(w.grad.numpy(), expect, rtol=1e-5)


def test_hessian_vector_product():
    A = np.array([[2.0, 1.0], [1.0, 3.0]], "float32")
    x = t([1.0, -1.0])
    v = paddle.to_tensor(np.array([0.5, 2.0], "float32"))
    f = 0.5 * (x * paddle.matmul(paddle.to_tensor(A),
                                 x.reshape([2, 1])).reshape([2])).sum()
    (g,) = paddle.grad(f, x, create_graph=True)
    (hv,) = paddle.grad((g * v).sum(), x)
    np.testing.assert_allclose(hv.numpy(), A @ v.numpy(), rtol=1e-5)


def test_through_a_linear_layer():
    """The reference's nn.Linear case with the layer written in Tensor
    ops (`nn.Linear` is ROADMAP item 1e)."""
    rs = np.random.RandomState(0)
    w = t(rs.randn(4, 1) * 0.5)
    b = t(np.zeros(1))
    x = t(rs.randn(3, 4))
    (gx,) = paddle.grad(paddle.tanh(paddle.matmul(x, w) + b).sum(), x,
                        create_graph=True)
    (gx ** 2).sum().backward()
    assert w.grad is not None and np.isfinite(w.grad.numpy()).all()
    assert b.grad is not None


def test_mixed_with_first_order():
    x = t([1.0, 2.0])
    paddle.grad((x ** 2).sum(), x, create_graph=True)
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])


def test_autograd_backward_of_several_roots():
    x = t([1.0, 2.0])
    autograd.backward([(x * 2).sum(), (x * x).sum()])
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])


def test_run_backward_restricted_to_listed_inputs():
    """restrict_to: only the listed tensors receive gradients."""
    from paddle_tpu_torch.core.engine import run_backward

    x, w = t([1.0, 2.0]), t([3.0, 4.0])
    run_backward((x * w).sum(), restrict_to=[x])
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 4.0])
    assert w.grad is None


# --------------------------------------------------------- jacobian, hessian
def _both(fn_pt, fn_ref, xs):
    mine = fn_pt([paddle.to_tensor(x) for x in xs])
    theirs = fn_ref([ref.to_tensor(x) for x in xs])
    return mine, theirs


def test_jacobian_matches_reference():
    x = np.array([1.0, 2.0, 0.5], "float32")
    mine = autograd.jacobian(lambda v: v ** 2 * paddle.sin(v),
                             paddle.to_tensor(x))
    theirs = ref.autograd.jacobian(lambda v: v ** 2 * ref.sin(v),
                                   ref.to_tensor(x))
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-5)
    y = np.array([0.3, -1.0], "float32")
    m2 = autograd.jacobian(lambda a, b: (a[:2] * b).sum() + a.sum(),
                           [paddle.to_tensor(x), paddle.to_tensor(y)])
    r2 = ref.autograd.jacobian(lambda a, b: (a[:2] * b).sum() + a.sum(),
                               [ref.to_tensor(x), ref.to_tensor(y)])
    for a, b in zip(m2, r2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    xb = np.array([[1.0, 2.0], [3.0, 4.0], [0.5, 1.5]], "float32")
    mb = autograd.jacobian(lambda v: v ** 3, paddle.to_tensor(xb),
                           batch_axis=0)
    rb = ref.autograd.jacobian(lambda v: v ** 3, ref.to_tensor(xb),
                               batch_axis=0)
    assert mb.shape == list(rb.shape) == [3, 2, 2]
    np.testing.assert_allclose(mb.numpy(), rb.numpy(), rtol=1e-5)


def test_hessian_matches_reference():
    x = np.array([1.0, 2.0], "float32")
    mine = autograd.hessian(lambda v: (v ** 3).sum() + (v[0] * v[1]),
                            paddle.to_tensor(x))
    theirs = ref.autograd.hessian(lambda v: (v ** 3).sum() + (v[0] * v[1]),
                                  ref.to_tensor(x))
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(mine.numpy(), [[6.0, 1.0], [1.0, 12.0]])
    xb = np.array([[1.0, 2.0], [3.0, 4.0]], "float32")
    mb = autograd.hessian(lambda v: (v ** 3).sum(), paddle.to_tensor(xb),
                          batch_axis=0)
    rb = ref.autograd.hessian(lambda v: (v ** 3).sum(), ref.to_tensor(xb),
                              batch_axis=0)
    np.testing.assert_allclose(mb.numpy(), rb.numpy(), rtol=1e-5)


# ------------------------------------------------------------ PyLayer
class _Cube(autograd.PyLayer):
    @staticmethod
    def forward(ctx, x, k=3.0):
        ctx.save_for_backward(x)
        ctx.k = k
        return x ** 3 * k

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor()
        assert isinstance(x, paddle.Tensor) and isinstance(g, paddle.Tensor)
        return g * 3 * x ** 2 * ctx.k


class _SplitSign(autograd.PyLayer):
    """Two outputs, one of them non-differentiable."""

    @staticmethod
    def forward(ctx, x, y):
        s = paddle.sign(x)
        ctx.mark_non_differentiable(s)
        ctx.save_for_backward(x, y)
        return x * y, s

    @staticmethod
    def backward(ctx, g, gs):
        x, y = ctx.saved_tensor()
        return g * y, g * x


def test_pylayer_forward_backward_with_tensors():
    x = t([1.0, 2.0])
    out = _Cube.apply(x, k=2.0)
    assert isinstance(out, paddle.Tensor) and not out.stop_gradient
    np.testing.assert_allclose(out.numpy(), [2.0, 16.0])
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 24.0])


def test_pylayer_multi_output_and_non_differentiable():
    x, y = t([1.0, -2.0]), t([3.0, 4.0])
    prod, s = _SplitSign.apply(x, y)
    assert s.stop_gradient and not prod.stop_gradient
    (prod.sum() + s.sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 4.0])
    np.testing.assert_allclose(y.grad.numpy(), [1.0, -2.0])


def test_pylayer_materialize_grads_off_passes_none():
    seen = []

    class Two(autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.set_materialize_grads(False)
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, g1, g2):
            seen.append((g1 is None, g2 is None))
            return g1 * 2

    x = t([1.0])
    a, _ = Two.apply(x)
    a.sum().backward()
    assert seen == [(False, True)]
    np.testing.assert_allclose(x.grad.numpy(), [2.0])


def test_pylayer_under_no_grad_records_nothing():
    x = t([1.0, 2.0])
    with paddle.no_grad():
        out = _Cube.apply(x)
    assert out.stop_gradient


# ------------------------------------------------------------ grad mode
def test_grad_mode_switches():
    x = t([1.0])

    @paddle.no_grad()
    def f(v):
        return v * 2

    assert f(x).stop_gradient
    with paddle.no_grad():
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient
        assert (x * 2).stop_gradient
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled() and (x * 2).stop_gradient
    assert paddle.is_grad_enabled()
    with torch.no_grad():                 # one switch with torch's
        assert (x * 2).stop_gradient


def test_saved_tensors_hooks_see_tensors():
    packed = []

    def pack(v):
        assert isinstance(v, paddle.Tensor)
        packed.append(v.shape)
        return v.numpy()

    def unpack(a):
        return paddle.to_tensor(a)

    x = t([1.0, 2.0])
    with autograd.saved_tensors_hooks(pack, unpack):
        y = (x * x).sum()
    y.backward()
    assert packed
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0])


def test_xla_machinery_is_not_ported():
    from paddle_tpu_torch.core import dispatch

    for fn in (dispatch.eager_cache_info, dispatch.eager_cache_clear,
               dispatch.lazy_mode):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn()
