"""The port's AdamW/Adam and amp.decorate against paddle_tpu's.

The same seeded parameters and gradients (numpy) go through
`paddle_tpu.optimizer.AdamW` and `paddle_tpu_torch.optimizer.AdamW` for
one and five steps, with weight decay, `apply_decay_param_fun` and
`lr_ratio`: in f32, in bf16 without multi_precision (bf16 moments,
f32 arithmetic) and in bf16 with multi_precision (f32 moments and master
weights). Both sides do the same f32 operations in the same order, so
parameters, moments and master weights must be bit-identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax.numpy as jnp
from paddle_tpu.core.tensor import Parameter, Tensor

from paddle_tpu_torch import amp
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay

SHAPES = [(8, 16), (16,), (5, 3, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") \
        and not torch.is_tensor(x) else x.detach().float().numpy()


def _run(dtype, multi_precision, steps, decoupled=True):
    """Reference and port after `steps` steps: per parameter (param,
    moment1, moment2, master or None), as f32 numpy."""
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(0)
    inits = [rs.randn(*s).astype("float32") * 0.5 for s in SHAPES]
    grads = [[rs.randn(*s).astype("float32") for s in SHAPES]
             for _ in range(steps)]
    kw = dict(learning_rate=1e-2, multi_precision=multi_precision,
              weight_decay=0.05)
    ratio = lambda p: 0.5 if len(p.shape) == 1 else 1.0   # noqa: E731

    ref = [Parameter(jnp.asarray(a).astype(jdt)) for a in inits]
    index = {p.name: i for i, p in enumerate(ref)}
    if decoupled:
        ropt = paddle.optimizer.AdamW(
            parameters=ref, lr_ratio=ratio,
            apply_decay_param_fun=lambda n: index[n] != 1, **kw)
    else:
        ropt = paddle.optimizer.Adam(parameters=ref, **kw)
    port = [torch.nn.Parameter(torch.from_numpy(a).to(tdt)) for a in inits]
    named = [(f"w{i}", p) for i, p in enumerate(port)]
    if decoupled:
        popt = AdamW(parameters=named, lr_ratio=ratio,
                     apply_decay_param_fun=lambda n: n != "w1", **kw)
    else:
        popt = Adam(parameters=named, **kw)

    for gs in grads:
        for p, g in zip(ref, gs):
            p.grad = Tensor(jnp.asarray(g).astype(jdt))
        ropt.step()
        ropt.clear_grad()
        for p, g in zip(port, gs):
            p.grad = torch.from_numpy(g).to(tdt)
        popt.step()
        popt.clear_grad()

    def ref_state(p):
        master = ropt._master_weights.get(id(p))
        acc = ropt._accumulators
        return (_f32(p._data), _f32(acc["moment1"][id(p)]._data),
                _f32(acc["moment2"][id(p)]._data),
                None if master is None else _f32(master._data))

    def port_state(p):
        st = popt.state[p]
        master = st.get("master")
        assert p.dtype == tdt
        return (_f32(p), _f32(st["moment1"]), _f32(st["moment2"]),
                None if master is None else _f32(master))

    return [ref_state(p) for p in ref], [port_state(p) for p in port], popt


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("dtype,multi_precision", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)],
    ids=["f32", "bf16-moments", "bf16-master"])
def test_adamw_steps_bit_identical(dtype, multi_precision, steps):
    want, got, popt = _run(dtype, multi_precision, steps)
    low = dtype == "bfloat16"
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b, a)
        # moments stay in the parameter's dtype unless multi_precision;
        # master weights exist only for low-precision multi_precision
        assert (g[3] is not None) == (low and multi_precision)
    st = next(iter(popt.state.values()))
    want_acc = torch.float32 if multi_precision or not low \
        else torch.bfloat16
    assert st["moment1"].dtype == st["moment2"].dtype == want_acc


def test_adam_coupled_decay_bit_identical():
    want, got, _ = _run("float32", False, 3, decoupled=False)
    for w, g in zip(want, got):
        for a, b in zip(w[:3], g[:3]):
            np.testing.assert_array_equal(b, a)


def test_adamw_defaults_and_paddle_names():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(parameters=[p])
    assert opt._weight_decay == 0.01 and opt.get_lr() == 0.001
    p.grad = torch.ones(3)
    opt.step()
    opt.clear_grad()
    assert p.grad is None and opt._step_count == 1
    # a scheduler is read at each step; anything else that is not a
    # number is refused, as the reference's jnp.asarray refuses it
    sched = StepDecay(0.5, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.5
    sched.step()
    assert opt.get_lr() == 0.25
    with pytest.raises(TypeError):
        AdamW(learning_rate=lambda: 1.0, parameters=[p])


def _ref_llama():
    from paddle_tpu.text.models import LlamaForCausalLM
    from paddle_tpu.text.models.llama import llama_tiny_config

    return LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2))


@pytest.mark.parametrize("master_weight", [None, False, True])
def test_decorate_o2_dtypes_and_multi_precision(master_weight):
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    ref = _ref_llama()
    ropt = paddle.optimizer.AdamW(parameters=ref.parameters())
    ref, ropt = paddle.amp.decorate(ref, ropt, level="O2", dtype="bfloat16",
                                    master_weight=master_weight)
    port = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                            device="cpu")
    popt = AdamW(parameters=port.parameters())
    port, popt = amp.decorate(port, popt, level="O2", dtype="bfloat16",
                              master_weight=master_weight)
    want = {k.replace("llama.", "model.", 1): str(v.dtype)
            for k, v in ref.state_dict().items()}
    got = {k: str(v.dtype).replace("torch.", "")
           for k, v in port.state_dict().items()}
    assert got == {k: want[k] for k in got} \
        and set(got.values()) == {"bfloat16"}
    assert port.model.rope_cos.dtype == torch.bfloat16
    assert popt._multi_precision == ropt._multi_precision \
        == (master_weight is not False)


def test_decorate_keeps_layer_norm_f32_and_refuses_o1():
    import paddle_tpu.nn as pnn

    ref = pnn.Sequential(pnn.Linear(4, 8), pnn.LayerNorm(8))
    paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
    port = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.LayerNorm(8))
    amp.decorate(port, level="O2", dtype="bfloat16")
    assert [str(p.dtype) for p in ref.parameters()] == \
        [str(p.dtype).replace("torch.", "") for p in port.parameters()] == \
        ["bfloat16", "bfloat16", "float32", "float32"]
    # decorate at O1, the default, leaves the parameters as they are, as
    # the reference's does; O1's per-op casting (auto_cast) is not ported
    ref1 = pnn.Linear(4, 8)
    paddle.amp.decorate(ref1)
    port1 = torch.nn.Linear(4, 8)
    assert amp.decorate(port1) is port1
    assert {str(p.dtype) for p in ref1.parameters()} == {"float32"}
    assert {p.dtype for p in port1.parameters()} == {torch.float32}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        with amp.auto_cast(level="O1"):
            pass
    with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
        pass
