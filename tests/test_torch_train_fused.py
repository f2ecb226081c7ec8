"""The port's fused training step against paddle_tpu's: the slice as a whole.

With `FLAGS_pallas_fused_ops=True` (both packages' default) LLaMA's norms
(the residual add fused into the post-attention norm), rotary and SwiGLU
run through the fused ops: the reference's Pallas kernels, forced on here
in interpret mode (`pallas_norm.FORCE_PALLAS=True`, as
tests/test_pallas_norm.py does), and the port's `ops.fused_norm`
autograd Functions, whose CPU path is each kernel's plain version. Tiny
LLaMA configs are built in paddle_tpu and carried into the port with
`llama_from_numpy`; both take the same three AdamW steps (lr 1e-3) on the
same seeded batch. Cases: MHA (K4 rotates Q and K together) with vocab
256 (plain cross-entropy) and GQA (K4 gated off: the composition rotates
Q and K) with vocab 4096 (the fused linear cross-entropy).

  * f32: the loss at every step within 1e-5 relative, the first
    backward's gradients and the weights after three steps within 1e-4 of
    each tensor's largest |value| (summation order through a few layers
    and three updates).
  * bf16 O2 (`amp.decorate(level="O2", master_weight=False)`): the loss at
    every step within 5e-3 relative (the two sides round bf16 activations
    at different places).

The port's flag-on forward also matches its own flag-off forward in f32
(same function, other arithmetic order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import pallas_norm as pn
from test_torch_train import _rel, _train

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny_config

CASES = {"mha-plain-ce": {},
         "gqa-fused-ce": {"num_key_value_heads": 2, "vocab_size": 4096}}
STEPS = 3


@pytest.fixture
def fused_flags():
    keys = ("FLAGS_pallas_fused_ops", "FLAGS_eager_defer_vjp")
    old = paddle.get_flags(list(keys))
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": True,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": True})
    pn.FORCE_PALLAS = True
    yield
    pn.FORCE_PALLAS = None
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})


@pytest.mark.parametrize("case", list(CASES))
def test_f32_fused_steps_match_reference(fused_flags, case):
    losses, grads, weights = _train(CASES[case], bf16=False, steps=STEPS)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0]
    assert set(grads["port"]) == set(grads["ref"])
    for name, g in grads["port"].items():
        want = grads["ref"][name]
        assert _rel(g, want) <= 1e-4, name
    for name, w in weights["port"].items():
        assert _rel(w, weights["ref"][name]) <= 1e-4, name


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_o2_fused_losses_match_reference(fused_flags, case):
    losses, _, _ = _train(CASES[case], bf16=True, steps=STEPS)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=5e-3)
    assert losses["port"][-1] < losses["port"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_fused_forward_matches_unfused(case):
    """Flag on and off give the same f32 loss and gradients (1e-5 of each
    tensor's largest |value|): the fused ops are the compositions'
    function."""
    torch.manual_seed(0)
    model = LlamaForCausalLM(llama_tiny_config(**CASES[case]), device="cpu")
    vocab = model.config.vocab_size
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, vocab,
                                                            (2, 33)))
    old = flag("FLAGS_pallas_fused_ops")
    out = []
    try:
        for fused in (True, False):
            set_flags({"FLAGS_pallas_fused_ops": fused})
            loss = model(ids, labels=ids)
            loss.backward()
            out.append((loss.item(), {n: p.grad.clone()
                                      for n, p in model.named_parameters()}))
            model.clear_gradients()
    finally:
        set_flags({"FLAGS_pallas_fused_ops": old})
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for name, g in out[0][1].items():
        want = out[1][1][name]
        assert ((g - want).abs().max() / want.abs().max()).item() <= 1e-5, \
            name
