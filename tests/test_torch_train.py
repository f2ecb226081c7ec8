"""The port's training step against paddle_tpu's: the slice as a whole.

Tiny LLaMA configs are built in paddle_tpu, their weights carried into the
port with `llama_from_numpy`, and both packages run the same five AdamW
steps (lr 1e-3) on the same seeded batch, `loss = model(x, x)` as the
reference's bench step does. Cases: MHA with vocab 256 (the plain
cross-entropy branch) and GQA with vocab 4096 (the reference's fused
linear cross-entropy branch, `llama.py:290`).

  * f32: the loss at every step within 1e-5 relative, the first
    backward's gradients within 1e-4 of each tensor's largest |value|, and
    the weights after five steps (`llama_to_numpy`) within 1e-4 of each
    tensor's largest |value| (both sides f32; the bounds cover summation
    order through a few layers and five updates).
  * bf16 O2 (`amp.decorate(level="O2", master_weight=False)`, bf16 AdamW
    moments): the loss at every step within 5e-3 relative (the two sides
    round bf16 activations at different places).

Both packages run with `FLAGS_pallas_fused_ops=False` here: the plain
compositions, the configuration of the unfused path
(`test_torch_train_fused.py` covers the fused one). The reference takes
its eager VJPs directly
(`FLAGS_eager_defer_vjp=False`: the deferred-VJP path's liveness analysis
reads `jax.core.Var`, which this jax no longer has; the math is the same).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM
from paddle_tpu.text.models.llama import llama_tiny_config as p_tiny

from paddle_tpu_torch import amp
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                          llama_from_numpy, llama_to_numpy,
                                          llama_tiny_config)

CASES = {"mha-plain-ce": {},
         "gqa-fused-ce": {"num_key_value_heads": 2, "vocab_size": 4096}}
STEPS = 5


@pytest.fixture
def ref_flags():
    keys = ("FLAGS_pallas_fused_ops", "FLAGS_eager_defer_vjp")
    old = paddle.get_flags(list(keys))
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": False,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": False})
    yield
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})


def _train(kw, bf16, steps=STEPS):
    """(reference, port) after `steps` steps: losses, first gradients
    {state key: f32 array} (one layout: the port's Linear weights are the
    reference's [in, out]), final weights."""
    paddle.seed(0)
    ref = PLlamaForCausalLM(p_tiny(**kw))
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = llama_from_numpy(llama_tiny_config(**kw), state, device="cpu")
    ropt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=ref.parameters())
    popt = AdamW(learning_rate=1e-3, parameters=port.parameters())
    if bf16:
        ref, ropt = paddle.amp.decorate(ref, ropt, level="O2",
                                        dtype="bfloat16", master_weight=False)
        port, popt = amp.decorate(port, popt, level="O2", dtype="bfloat16",
                                  master_weight=False)
    ids = np.random.RandomState(0).randint(0, kw.get("vocab_size", 256),
                                           (2, 33))
    x, tx = paddle.to_tensor(ids), torch.from_numpy(ids)
    ref_names = {id(p): n for n, p in ref.named_parameters()}
    out = {"ref": [], "port": []}
    grads = {}
    for step in range(steps):
        with paddle.amp.auto_cast(enable=bf16, dtype="bfloat16", level="O2"):
            loss = ref(x, x)
        loss.backward()
        if step == 0:
            grads["ref"] = {ref_names[id(p)]: np.asarray(
                p.grad._data).astype("float32") for p in ref.parameters()}
        ropt.step()
        ropt.clear_grad()
        with amp.auto_cast(enable=bf16, dtype="bfloat16", level="O2"):
            ploss = port(tx, labels=tx)
        ploss.backward()
        if step == 0:
            grads["port"] = {n: p.grad.numpy().astype("float32")
                             for n, p in port.named_parameters()}
        popt.step()
        popt.clear_grad()
        out["ref"].append(float(np.asarray(loss._data)))
        out["port"].append(ploss.item())
    weights = {"ref": {k: np.asarray(v._data).astype("float32")
                       for k, v in ref.state_dict().items()},
               "port": llama_to_numpy(port)}
    return out, grads, weights


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", list(CASES))
def test_f32_steps_match_reference(ref_flags, case):
    losses, grads, weights = _train(CASES[case], bf16=False)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0]
    assert set(grads["port"]) == set(grads["ref"])
    for name, g in grads["port"].items():
        want = grads["ref"][name]
        assert _rel(g, want) <= 1e-4, name
    assert set(weights["port"]) <= set(weights["ref"])
    for name, w in weights["port"].items():
        assert _rel(w, weights["ref"][name]) <= 1e-4, name


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_o2_losses_match_reference(ref_flags, case):
    losses, _, _ = _train(CASES[case], bf16=True)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=5e-3)
    assert losses["port"][-1] < losses["port"][0]


@pytest.mark.parametrize("chunking", [
    {}, {"chunk_axis": "vocab", "chunk_size": 10},
    {"chunk_axis": "tokens", "token_chunk": 4},
    {"chunk_axis": "vocab", "chunk_size": 0}])
def test_fused_loss_matches_plain_cross_entropy(chunking):
    """The fused-CE branch equals the plain one on the same logits, with
    ignored labels left out of the mean, on each chunk axis (vocab slices
    of 10, 18 tokens in chunks of 4 with a ragged last one, unchunked);
    its gradients too (1e-5 relative: f32 sums in another order)."""
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy

    rs = np.random.RandomState(1)
    h = torch.from_numpy(rs.randn(2, 9, 16).astype("float32"))
    w = torch.from_numpy(rs.randn(16, 50).astype("float32"))
    lab = torch.from_numpy(rs.randint(0, 50, (2, 9)))
    lab[0, :3] = -100
    lab[1, 0] = -5
    h.requires_grad_(True)
    w.requires_grad_(True)
    got = fused_linear_cross_entropy(h, w, lab, **chunking)
    got_grads = torch.autograd.grad(got, (h, w))
    keep = lab.reshape(-1) >= 0
    want = torch.nn.functional.cross_entropy(
        (h.reshape(-1, 16) @ w)[keep], lab.reshape(-1)[keep])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(got_grads, torch.autograd.grad(want, (h, w))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_unported_switches_raise():
    model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    model(ids, labels=ids).backward()
    for kw in ({"tensor_parallel": True}, {"sequence_parallel": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LlamaForCausalLM(llama_tiny_config(**kw), device="cpu")
