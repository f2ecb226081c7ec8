"""The port's GPT training step against paddle_tpu's: the GPT slice as a
whole.

Tiny GPTs (hidden 64, 2 layers, 4 heads, sequence 16) are built in
paddle_tpu and carried into the port with `gpt_from_numpy`; both take the
same three AdamW steps (lr 1e-3) on the same seeded batch, `loss =
model(x, x)` as the reference's bench step does, with
`FLAGS_pallas_fused_ops` on and the reference's Pallas kernels forced
into interpret mode on both gates (`pallas_norm.FORCE_PALLAS` for the
LayerNorms, `nn.functional.attention.FORCE_PALLAS` for the flash
attention); the port's fused ops run their kernels' plain versions on
the CPU. Cases: vocab 256 (the plain cross-entropy) and vocab 4096 (the
fused linear cross-entropy branch), f32 and bf16 O2.

  * f32: the loss at every step within 1e-5 relative, the first
    backward's gradients and the weights after three steps within 1e-4 of
    each tensor's largest |value| (the tiers of test_torch_train_fused).
  * bf16 O2 (`amp.decorate(level="O2", master_weight=False)`): the loss at
    every step within 5e-3 relative (the two sides round bf16 activations
    at different places).

Also: the port's flag-on forward equals its flag-off forward in f32; the
numpy round trip; the unported switches raise. The plain-CE f32 case and
the bf16 cases run in test_torch_gpt_plain.py and test_torch_gpt_bf16.py
(each case ~10–25 s: the reference's kernels in interpret mode).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional.attention as ref_attention
from paddle_tpu.ops import pallas_norm as pn
from paddle_tpu.text.models.gpt import GPTConfig as PGPTConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as PGPTForCausalLM

from paddle_tpu_torch import amp
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import (GPTConfig, GPTForCausalLM,
                                          gpt_from_numpy, gpt_to_numpy)

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
CASES = {"plain-ce": {"vocab_size": 256}, "fused-ce": {"vocab_size": 4096}}
STEPS = 3
SEQ = 16


@pytest.fixture
def fused_flags():
    """Both packages' fused ops on, the reference's kernels in interpret
    mode on the norm and attention gates."""
    keys = ("FLAGS_pallas_fused_ops", "FLAGS_eager_defer_vjp")
    old = paddle.get_flags(list(keys))
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": True,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": True})
    pn.FORCE_PALLAS = True
    ref_attention.FORCE_PALLAS = True
    yield
    pn.FORCE_PALLAS = None
    ref_attention.FORCE_PALLAS = None
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})


def reference_state(ref):
    return {k: np.asarray(v._data) for k, v in ref.state_dict().items()}


def train_both(ref, port, ref_loss, port_loss, bf16, steps=STEPS, lr=1e-3):
    """`steps` AdamW steps of the reference and the port, each from its
    own loss closure: (losses {"ref", "port"}, first gradients {"ref",
    "port"} keyed by state name, f32, in each package's layout)."""
    ropt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=ref.parameters())
    popt = AdamW(learning_rate=lr, parameters=port.parameters())
    if bf16:
        ref, ropt = paddle.amp.decorate(ref, ropt, level="O2",
                                        dtype="bfloat16", master_weight=False)
        port, popt = amp.decorate(port, popt, level="O2", dtype="bfloat16",
                                  master_weight=False)
    ref_names = {id(p): n for n, p in ref.named_parameters()}
    losses = {"ref": [], "port": []}
    grads = {}
    for step in range(steps):
        with paddle.amp.auto_cast(enable=bf16, dtype="bfloat16", level="O2"):
            loss = ref_loss()
        loss.backward()
        if step == 0:
            grads["ref"] = {ref_names[id(p)]: np.asarray(
                p.grad._data).astype("float32") for p in ref.parameters()
                if p.grad is not None}
        ropt.step()
        ropt.clear_grad()
        ploss = port_loss()
        ploss.backward()
        if step == 0:
            grads["port"] = {n: p.grad.numpy().astype("float32")
                             for n, p in port.named_parameters()
                             if p.grad is not None}
        popt.step()
        popt.clear_grad()
        losses["ref"].append(float(np.asarray(loss._data)))
        losses["port"].append(ploss.item())
    return losses, grads


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


#: BERT's attention key bias gets no gradient in exact arithmetic (a
#: query row's softmax ignores a shift common to all its keys): its
#: gradient is rounding noise on both sides, held to the scale of its key
#: weight's gradient, and AdamW turns that noise into steps of up to lr
#: either way, so its weights are held to 2 x steps x lr of each other
NULL_GRAD = "attention.key.bias"


def check_f32(port, losses, grads, ref_weights, port_weights, steps=STEPS,
              lr=1e-3):
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0]
    assert set(grads["port"]) == set(grads["ref"])
    for name, g in grads["port"].items():
        want = grads["ref"][name]
        if name.endswith(NULL_GRAD):
            scale = np.abs(grads["ref"][name[:-4] + "weight"]).max()
            assert np.abs(g - want).max() <= 1e-4 * scale, name
            continue
        assert rel(g, want) <= 1e-4, name
    assert set(port_weights) == set(ref_weights)
    for name, w in port_weights.items():
        want = ref_weights[name].astype("float32")
        if name.endswith(NULL_GRAD):
            assert np.abs(w - want).max() <= 2 * steps * lr, name
            continue
        assert rel(w, want) <= 1e-4, name


def _gpt_pair(kw):
    paddle.seed(0)
    ref = PGPTForCausalLM(PGPTConfig(**TINY, **kw))
    port = gpt_from_numpy(GPTConfig(**TINY, **kw), reference_state(ref),
                          device="cpu")
    ids = np.random.RandomState(0).randint(0, kw["vocab_size"], (2, SEQ))
    return ref, port, paddle.to_tensor(ids), torch.from_numpy(ids)


@pytest.mark.parametrize("case", ["fused-ce"])
def test_f32_gpt_steps_match_reference(fused_flags, case):
    ref, port, x, tx = _gpt_pair(CASES[case])
    losses, grads = train_both(ref, port, lambda: ref(x, x),
                               lambda: port(tx, labels=tx), bf16=False)
    check_f32(port, losses, grads, reference_state(ref), gpt_to_numpy(port))


def bf16_o2_losses_held(case):
    """The bf16 O2 case `case`, run under `fused_flags` by
    test_torch_gpt_bf16.py's `test_bf16_o2_gpt_losses_match_reference`."""
    ref, port, x, tx = _gpt_pair(CASES[case])
    losses, _ = train_both(ref, port, lambda: ref(x, x),
                           lambda: port(tx, labels=tx), bf16=True)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=5e-3)
    assert losses["port"][-1] < losses["port"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_gpt_fused_forward_matches_unfused(case):
    """Flag on and off give the same f32 loss and gradients (1e-5 of
    each tensor's largest |value|)."""
    torch.manual_seed(0)
    model = GPTForCausalLM(GPTConfig(**TINY, **CASES[case]), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, CASES[case]["vocab_size"], (2, 33)))
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


def test_gpt_numpy_round_trip_and_logits():
    """gpt_to_numpy(gpt_from_numpy(state)) is the state, bit for bit, and
    the logits equal the reference's (f32, composition paths)."""
    paddle.seed(1)
    kw = dict(TINY, vocab_size=256)
    ref = PGPTForCausalLM(PGPTConfig(**kw))
    state = reference_state(ref)
    port = gpt_from_numpy(GPTConfig(**kw), state, device="cpu")
    back = gpt_to_numpy(port)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    ids = np.random.RandomState(3).randint(0, 256, (2, SEQ))
    want = np.asarray(ref(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert rel(got, want) <= 1e-5


def test_gpt_unported_switches_raise():
    for kw in ({"tensor_parallel": True}, {"sequence_parallel": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GPTForCausalLM(GPTConfig(**TINY, vocab_size=256, **kw),
                           device="cpu")
    model = GPTForCausalLM(GPTConfig(**TINY, vocab_size=256), device="cpu")
    # generate serves (GPT serving is ported): prompt + 3 new tokens
    out = model.generate(torch.zeros(1, 4, dtype=torch.long),
                         max_new_tokens=3)
    assert out.shape == (1, 7) and out.dtype == torch.int64
    assert GPTConfig().intermediate_size == 4096


@pytest.mark.parametrize("arch", ["llama", "gpt", "bert"])
def test_to_numpy_returns_copies(arch):
    """The *_to_numpy arrays are copies: an optimizer step on an f32
    model leaves them as they were (they used to alias its f32
    parameters, so a state read before a step changed with it)."""
    from paddle_tpu_torch.text.models import (
        BertConfig, BertForSequenceClassification, LlamaForCausalLM,
        bert_to_numpy, llama_to_numpy, llama_tiny_config)

    torch.manual_seed(0)
    if arch == "llama":
        model, to_numpy = (LlamaForCausalLM(llama_tiny_config(),
                                            device="cpu"), llama_to_numpy)
    elif arch == "gpt":
        model, to_numpy = (GPTForCausalLM(GPTConfig(**TINY, vocab_size=256),
                                          device="cpu"), gpt_to_numpy)
    else:
        model, to_numpy = (BertForSequenceClassification(BertConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=128),
            device="cpu"), bert_to_numpy)
    before = to_numpy(model)
    kept = {k: v.copy() for k, v in before.items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for k, v in before.items():
        np.testing.assert_array_equal(v, kept[k])
    assert all(np.abs(to_numpy(model)[k] - kept[k]).min() > 0.5
               for k in kept)
