"""Shared body of tests/test_torch_nn_parity*.py: a layer built in both
packages from one seed, the reference's weights carried into the port
through `set_state_dict` (the reference's `state_dict` as numpy arrays;
keys and shapes must agree), the same numpy inputs through both, and the
forward held to 1e-5 and the gradients of a weighted sum (the inputs'
and every parameter's) to 1e-4, in f32. The reference's tape runs with
`FLAGS_eager_defer_vjp=False`.
"""
import numpy as np

import paddle_tpu as ref
import paddle_tpu.nn as rnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.core import device as port_device

FWD, GRAD = 1e-5, 1e-4


def on_cpu_with_the_reference_tape():
    """Generator body of the files' module fixture."""
    prev = port_device._current
    pt.set_device("cpu")
    old = ref.get_flags(["FLAGS_eager_defer_vjp"])
    ref.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref.set_flags(old)
    port_device._current = prev


def carry(rl, pl):
    """The reference layer's weights into the port's; the keys and
    shapes must be the same."""
    rsd = rl.state_dict()
    psd = pl.state_dict()
    assert list(psd) == list(rsd)
    for k in rsd:
        assert psd[k].shape == list(rsd[k].shape), k
    missing, unexpected = pl.set_state_dict(
        {k: np.asarray(v._data) for k, v in rsd.items()})
    assert not missing and not unexpected


def inputs(pkg, arrays, grad):
    return [pkg.to_tensor(a, stop_gradient=not g)
            for a, g in zip(arrays, grad)]


def first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def run(pkg, layer, arrays, grad, call, cot):
    ts = inputs(pkg, arrays, grad)
    out = first(call(layer, *ts))
    (out * pkg.to_tensor(cot)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()
             if p.grad is not None}
    ins = [t.grad.numpy() for t, g in zip(ts, grad) if g]
    return out.numpy(), grads, ins


def check(rl, pl, arrays, grad=None, call=None, seed=9):
    """Forward and gradients of the port's layer against the
    reference's."""
    grad = grad or [True] * len(arrays)
    call = call or (lambda layer, *xs: layer(*xs))
    carry(rl, pl)
    want = first(call(rl, *inputs(ref, arrays, [False] * len(arrays))))
    call(pl, *inputs(pt, arrays, [False] * len(arrays)))  # as many steps
    cot = np.random.RandomState(seed).randn(*want.shape).astype("float32")
    rout, rg, rin = run(ref, rl, arrays, grad, call, cot)
    pout, pg, pin = run(pt, pl, arrays, grad, call, cot)
    np.testing.assert_allclose(pout, rout, rtol=FWD, atol=FWD)
    assert set(pg) == set(rg)
    for k in rg:
        np.testing.assert_allclose(pg[k], rg[k], rtol=GRAD, atol=GRAD,
                                   err_msg=k)
    for a, b in zip(pin, rin):
        np.testing.assert_allclose(a, b, rtol=GRAD, atol=GRAD)
    return pout


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def both(build):
    ref.seed(0)
    pt.seed(0)
    return build(rnn), build(pnn)
