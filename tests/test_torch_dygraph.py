"""Dygraph training on the Tensor surface: the port against paddle_tpu
(CPU).

A two-layer MLP written in Tensor ops (`matmul`, `add`, `tanh`, `mean`),
its weights carried from numpy into both packages, trained 5 AdamW steps:
eagerly (losses and weights within 1e-5, f32), under `jit.to_static`
(each package's compiled steps equal its eager ones within 1e-5, and the
two packages each other), and under `amp.auto_cast(O1, bfloat16)` (the
ops' dtypes as the reference's lists give them, the losses within the
bf16 tolerance of tests/test_torch_amp.py). Then a closure Tensor written
in place under `no_grad` inside a `to_static` step (5 replays = 5 eager
calls), and a Tensor of ids through `LlamaForCausalLM.forward` and
`ServingEngine.add_request`. The reference's eager backward runs with
`FLAGS_eager_defer_vjp=False` (its deferred-VJP pass reads a removed
`jax.core.Var`), set and restored here.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.optimizer import AdamW

STEPS = 5
O1_TOL = 5e-3


@pytest.fixture(autouse=True)
def _setup():
    prev = port_device._current
    pt.set_device("cpu")
    old = ref.get_flags(["FLAGS_eager_defer_vjp"])
    ref.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref.set_flags(old)
    port_device._current = prev


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(16, 32) * 0.3).astype("float32"),
            (rs.randn(32) * 0.1).astype("float32"),
            (rs.randn(32, 4) * 0.3).astype("float32"),
            (rs.randn(4) * 0.1).astype("float32")]


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return rs.randn(8, 16).astype("float32"), rs.randn(8, 4).astype(
        "float32")


def _mlp(pkg, params, x, y):
    w1, b1, w2, b2 = params
    h = pkg.tanh(pkg.add(pkg.matmul(x, w1), b1))
    out = pkg.matmul(h, w2) + b2
    return ((out - y) ** 2).mean()


def _trainer(pkg, opt_cls, compiled=False):
    params = [pkg.to_tensor(w, stop_gradient=False) for w in _weights()]
    opt = opt_cls(learning_rate=0.05, parameters=params)

    def step(x, y):
        loss = _mlp(pkg, params, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return params, (pkg.jit.to_static(step) if compiled else step)


def _run(pkg, opt_cls, compiled=False):
    params, step = _trainer(pkg, opt_cls, compiled)
    x, y = (pkg.to_tensor(a) for a in _batch())
    losses = [float(step(x, y)) for _ in range(STEPS)]
    return losses, [p.numpy() for p in params], step


def test_mlp_adamw_steps_match_reference():
    mine, pw, _ = _run(pt, AdamW)
    theirs, rw, _ = _run(ref, ref.optimizer.AdamW)
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-6)
    assert mine[-1] < mine[0]
    for a, b in zip(pw, rw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_mlp_steps_under_to_static_match_eager_and_reference():
    eager, _, _ = _run(pt, AdamW)
    mine, pw, step = _run(pt, AdamW, compiled=True)
    theirs, rw, _ = _run(ref, ref.optimizer.AdamW, compiled=True)
    np.testing.assert_allclose(mine, eager, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-6)
    report = step.graph_break_report()
    assert len(step._cache) == 1 and report["compiled"]
    assert report["break_reason"] is None
    for a, b in zip(pw, rw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_mlp_steps_under_auto_cast_o1():
    mine, theirs = [], []
    for pkg, opt_cls, out in ((pt, AdamW, mine),
                              (ref, ref.optimizer.AdamW, theirs)):
        params = [pkg.to_tensor(w, stop_gradient=False) for w in _weights()]
        opt = opt_cls(learning_rate=0.05, parameters=params)
        x, y = (pkg.to_tensor(a) for a in _batch())
        for _ in range(STEPS):
            with pkg.amp.auto_cast(enable=True, level="O1",
                                   dtype="bfloat16"):
                loss = _mlp(pkg, params, x, y)
            assert loss.dtype == pkg.float32
            loss.backward()
            assert all(p.grad.dtype == pkg.float32 for p in params)
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
    np.testing.assert_allclose(mine, theirs, rtol=O1_TOL)
    assert mine[-1] < mine[0]


def test_o1_op_dtypes_follow_the_reference_lists():
    x = pt.to_tensor(_batch()[0])
    w = pt.to_tensor(_weights()[0])
    with amp.debugging.collect_operator_stats() as stats:
        with amp.auto_cast(enable=True, level="O1", dtype="bfloat16"):
            h = pt.matmul(x, w)
            e = pt.exp(h)
            m = pt.mean(e)
            t = pt.tanh(h)
    assert h.dtype == pt.bfloat16 and e.dtype == pt.float32
    assert m.dtype == pt.float32 and t.dtype == pt.bfloat16
    assert stats["matmul"] == {"bfloat16": 1}
    assert stats["exp"] == {"float32": 1} and stats["mean"] == {
        "float32": 1}


def test_inplace_write_under_no_grad_lands_in_the_compiled_step():
    """set_value and an op_ under no_grad on closure Tensors, inside a
    to_static step: after 5 calls (2 eager, 3 compiled) the values of 5
    eager calls."""

    def make():
        count = pt.to_tensor(np.zeros(3, "float32"))
        acc = pt.to_tensor(np.ones(3, "float32"))

        def step(x):
            with pt.no_grad():
                count.add_(pt.ones([3]))
                acc.scale_(0.5)
            tot = pt.to_tensor(np.zeros(3, "float32"))
            tot.set_value(count * 2 + x)
            return tot

        return count, acc, step

    c_e, a_e, f_e = make()
    c_s, a_s, f_s = make()
    f_s = jit.to_static(f_s)
    x = pt.to_tensor(np.arange(3, dtype="float32"))
    for _ in range(5):
        want, got = f_e(x), f_s(x)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(c_s.numpy(), c_e.numpy())
    np.testing.assert_array_equal(c_s.numpy(), [5.0] * 3)
    np.testing.assert_array_equal(a_s.numpy(), [0.5 ** 5] * 3)
    assert len(f_s._cache) == 1


def test_tensor_ids_through_the_model_and_the_engine():
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    rs = np.random.RandomState(0)
    ids_np = rs.randint(0, 256, (2, 9))
    ids = pt.to_tensor(ids_np)
    loss = m(ids, labels=ids)
    assert isinstance(loss, pt.Tensor) and loss.shape == []
    want = m(torch.from_numpy(ids_np), labels=torch.from_numpy(ids_np))
    assert float(loss) == float(want)
    loss.backward()
    assert m.model.layers[0].mlp.up_proj.weight.grad is not None
    logits = m(ids)
    assert isinstance(logits, pt.Tensor) and logits.shape == [2, 9, 256]
    eng = ServingEngine(m, max_slots=2, kv_block_size=8, device="cpu")
    eng2 = ServingEngine(m, max_slots=2, kv_block_size=8, device="cpu")
    prompt = ids_np[0, :5]
    eng.add_request(pt.to_tensor(prompt), max_new_tokens=4)
    eng2.add_request(prompt, max_new_tokens=4)
    out, out2 = eng.run(), eng2.run()
    assert [list(v) for v in out.values()] == [list(v) for v in
                                               out2.values()]
