"""The port's GradScaler against paddle_tpu's: the reference's five
behaviours (`tests/test_amp.py`'s GradScaler cases) on both packages from
the same numpy weights and inputs, and the traced branch under each
package's `to_static`.

  * scaled training equals unscaled training (SGD, 5 steps), each
    package's scaled weights within 1e-6 of its unscaled ones and of the
    other package's;
  * a non-finite gradient skips the step and halves the scale;
  * the scale doubles after `incr_every_n_steps` good steps;
  * `unscale_` leaves O(1) gradients before a clip;
  * `state_dict` / `load_state_dict` round trip;
  * inside a compiled step (the port's `to_static` marker: discovery and
    the compiled call) an overflow takes the reference's traced branch:
    the gradients are zeroed and the step runs, and the scale halves. SGD
    with zero gradients leaves the weights as they were, in both packages.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as pnn

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.optimizer import SGD


@pytest.fixture(autouse=True)
def ref_vjp():
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)


def _pair(n_in=8, n_out=4, seed=0):
    """A reference Linear and a port Linear with the same weights."""
    paddle.seed(seed)
    ref = pnn.Linear(n_in, n_out)
    port = torch.nn.Linear(n_in, n_out)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight._data).T))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias._data)))
    return ref, port


def _scaled_step(scaler, opt, loss):
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()


def _scale(s):
    v = s._scale
    return float(v.numpy() if hasattr(v, "numpy") and not isinstance(
        v, torch.Tensor) else v.item())


def test_scaled_training_matches_unscaled():
    rs = np.random.RandomState(0)
    xn = rs.rand(4, 8).astype("float32")
    finals = {}
    for lib in ("ref", "port"):
        runs = []
        for scaled in (False, True):
            ref, port = _pair()
            if lib == "ref":
                m, x = ref, paddle.to_tensor(xn)
                opt = paddle.optimizer.SGD(learning_rate=0.1,
                                           parameters=m.parameters())
                sc = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 8)
            else:
                m, x = port, torch.from_numpy(xn)
                opt = SGD(learning_rate=0.1, parameters=m.parameters())
                sc = amp.GradScaler(init_loss_scaling=2.0 ** 8,
                                    device="cpu")
            for _ in range(5):
                loss = (m(x) ** 2).mean()
                if scaled:
                    _scaled_step(sc, opt, loss)
                else:
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
            w = m.weight
            runs.append(np.asarray(w._data) if lib == "ref"
                        else w.detach().numpy().T)
        np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5, atol=1e-6)
        finals[lib] = runs[1]
    np.testing.assert_allclose(finals["port"], finals["ref"], rtol=1e-5,
                               atol=1e-6)


def test_nonfinite_skips_step_and_shrinks_scale():
    xn = np.full((2, 4), np.inf, "float32")
    for lib in ("ref", "port"):
        ref, port = _pair(4, 4)
        if lib == "ref":
            m, x = ref, paddle.to_tensor(xn)
            opt = paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=m.parameters())
            sc = paddle.amp.GradScaler(init_loss_scaling=1024.0,
                                       decr_ratio=0.5,
                                       incr_every_n_steps=10 ** 9)
            before = np.asarray(m.weight._data).copy()
        else:
            m, x = port, torch.from_numpy(xn)
            opt = SGD(learning_rate=0.1, parameters=m.parameters())
            sc = amp.GradScaler(init_loss_scaling=1024.0, decr_ratio=0.5,
                                incr_every_n_steps=10 ** 9, device="cpu")
            before = m.weight.detach().clone().numpy()
        _scaled_step(sc, opt, m(x).sum())
        after = np.asarray(m.weight._data) if lib == "ref" \
            else m.weight.detach().numpy()
        np.testing.assert_array_equal(after, before)
        assert _scale(sc) == 512.0, lib


def test_scale_grows_after_n_good_steps():
    xn = np.random.RandomState(2).rand(2, 4).astype("float32")
    for lib in ("ref", "port"):
        ref, port = _pair(4, 4)
        if lib == "ref":
            m, x = ref, paddle.to_tensor(xn)
            opt = paddle.optimizer.SGD(learning_rate=0.0,
                                       parameters=m.parameters())
            sc = paddle.amp.GradScaler(init_loss_scaling=2.0,
                                       incr_every_n_steps=2, incr_ratio=2.0)
        else:
            m, x = port, torch.from_numpy(xn)
            opt = SGD(learning_rate=0.0, parameters=m.parameters())
            sc = amp.GradScaler(init_loss_scaling=2.0, incr_every_n_steps=2,
                                incr_ratio=2.0, device="cpu")
        for _ in range(4):
            _scaled_step(sc, opt, m(x).sum())
        assert _scale(sc) == 8.0, lib


def test_unscale_then_clip():
    xn = np.random.RandomState(3).rand(2, 4).astype("float32")
    grads = {}
    for lib in ("ref", "port"):
        ref, port = _pair(4, 4)
        if lib == "ref":
            m, x = ref, paddle.to_tensor(xn)
            opt = paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=m.parameters())
            sc = paddle.amp.GradScaler(init_loss_scaling=256.0)
        else:
            m, x = port, torch.from_numpy(xn)
            opt = SGD(learning_rate=0.1, parameters=m.parameters())
            sc = amp.GradScaler(init_loss_scaling=256.0, device="cpu")
        sc.scale(m(x).sum()).backward()
        sc.unscale_(opt)
        g = m.weight.grad
        grads[lib] = np.asarray(g._data) if lib == "ref" \
            else g.numpy().T
        assert np.abs(grads[lib]).max() < 50.0
        # a second unscale_ in the same step does nothing
        sc.unscale_(opt)
        sc.step(opt)
        sc.update()
    np.testing.assert_allclose(grads["port"], grads["ref"], rtol=1e-6)


def test_state_dict_round_trip():
    ref_sc = paddle.amp.GradScaler(init_loss_scaling=123.0, incr_ratio=3.0)
    port_sc = amp.GradScaler(init_loss_scaling=123.0, incr_ratio=3.0,
                             device="cpu")
    rs, ps = ref_sc.state_dict(), port_sc.state_dict()
    assert set(ps) == set(rs)
    assert float(ps["scale"]) == float(rs["scale"]) == 123.0
    assert {k: v for k, v in ps.items() if k != "scale"} \
        == {k: v for k, v in rs.items() if k != "scale"}
    other = amp.GradScaler(device="cpu")
    other.load_state_dict(ps)
    assert other.get_loss_scaling().item() == 123.0
    other.set_init_loss_scaling(7.0)
    assert other.get_loss_scaling().item() == 7.0
    assert other.is_enable() and not amp.GradScaler(
        enable=False, device="cpu").is_enable()


def test_traced_branch_inside_to_static():
    """An overflow at the compiled call: the reference's traced branch
    (zeroed gradients, then the step) in both packages' `to_static`; SGD
    leaves the weights, the scale halves; the good steps before it match
    between the packages."""
    rs = np.random.RandomState(4)
    xn = rs.rand(4, 8).astype("float32")
    out = {}
    for lib in ("ref", "port"):
        ref, port = _pair()
        if lib == "ref":
            m, x = ref, paddle.to_tensor(xn)
            opt = paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=m.parameters())
            sc = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10)
            bomb = paddle.to_tensor(np.ones((), "float32"))
            to_static = paddle.jit.to_static
        else:
            m, x = port, torch.from_numpy(xn)
            opt = SGD(learning_rate=0.1, parameters=m.parameters())
            sc = amp.GradScaler(init_loss_scaling=2.0 ** 10, device="cpu")
            bomb = torch.ones(())
            to_static = jit.to_static

        def body(x):
            loss = (m(x) ** 2).mean() * bomb
            _scaled_step(sc, opt, loss)
            return loss

        step = to_static(body)
        for _ in range(3):
            step(x)
        w = np.array(m.weight._data if lib == "ref"
                     else m.weight.detach().numpy().T)
        if lib == "ref":
            bomb._data = bomb._data * np.float32(np.inf)
        else:
            bomb.fill_(float("inf"))
        step(x)
        after = np.asarray(m.weight._data) if lib == "ref" \
            else m.weight.detach().numpy().T
        np.testing.assert_array_equal(after, w)
        assert _scale(sc) == 2.0 ** 9, lib
        assert len(step._cache) == 1
        out[lib] = w
    np.testing.assert_allclose(out["port"], out["ref"], rtol=1e-5,
                               atol=1e-6)

