"""The port's Layer models' calls held to their contracts on the CPU
(ROADMAP.md Queue 1 item 11; the models and helpers of
test_torch_models_layer.py): each recompute granularity gives the plain
gradients, the models take and return Tensors, the layers return the
kind of their inputs, and O2 norm outputs come from the AMP rule.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny_config
from test_torch_models_layer import _on_cpu, carried, ids_for  # noqa: F401


@pytest.mark.parametrize("gran", ["full", "mlp", "flash_resident"])
def test_recompute_gives_the_plain_gradients(gran):
    """Each recompute granularity of the Layer model gives the gradients
    of the same model without recompute (1e-6 of each tensor's largest
    |value|): `recompute` sees the layers' Parameters."""
    _, port = carried("llama-gqa")
    ids = torch.from_numpy(ids_for("llama-gqa"))
    grads = []
    for use in (False, True):
        port.config.use_recompute = use
        port.config.recompute_granularity = gran
        for layer in port.model.layers:
            layer.recompute_mlp = use and gran == "mlp"
        loss = port(ids, labels=ids)
        loss.backward()
        grads.append({n: p.grad.numpy() for n, p in port.named_parameters()})
        port.clear_gradients()
    for n, g in grads[1].items():
        w = grads[0][n]
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), n


def test_models_take_and_return_tensors():
    """Called with the Tensor API's Tensors, a model returns a Tensor
    whose backward reaches the Parameters' `.grad`."""
    _, port = carried("gpt")
    ids = pt.to_tensor(ids_for("gpt"))
    loss = port(ids, labels=ids)
    assert isinstance(loss, pt.Tensor) and loss.shape == []
    loss.backward()
    assert all(isinstance(p.grad, pt.Tensor) for p in port.parameters())
    out = port(ids)
    assert isinstance(out, pt.Tensor) and out.shape == [2, 19, 256]


@pytest.mark.parametrize("kind", ["linear", "layer_norm", "fused_add"])
def test_layers_return_the_kind_of_their_inputs(kind):
    """An `nn` layer called on torch tensors gives torch tensors (its own
    Parameters do not make the result a Tensor: the models' forwards call
    their layers so), and on Tensors gives Tensors; the values agree."""
    torch.manual_seed(0)
    x, r = torch.randn(3, 8), torch.randn(3, 8)
    if kind == "linear":
        layer = pt.nn.Linear(8, 8)
        call = layer
    else:
        layer = pt.nn.LayerNorm(8)
        call = layer if kind == "layer_norm" else layer.forward_fused_add
    args = (x,) if kind != "fused_add" else (x, r)
    raw = call(*args)
    wrapped = call(*(pt.Tensor._wrap(a) for a in args))
    raw, wrapped = ((raw,), (wrapped,)) if kind != "fused_add" \
        else (raw, wrapped)
    for a, b in zip(raw, wrapped):
        assert type(a) is torch.Tensor and isinstance(b, pt.Tensor)
        assert torch.equal(a, b._data)


def test_o2_norm_outputs_come_from_the_amp_rule():
    """A LLaMA that `amp.decorate` put at O2 writes its final norm in f32
    (the rule's BLACK_LIST `rms_norm`) with `auto_cast` on and off alike,
    and the same values; an undecorated bf16 model, outside AMP, writes
    it in bf16."""
    from paddle_tpu_torch import amp

    cfg = llama_tiny_config()
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 9)))
    torch.manual_seed(0)
    model = amp.decorate(LlamaForCausalLM(cfg, device="cpu"), level="O2",
                         dtype="bfloat16")
    off = model.model(ids)
    with amp.auto_cast(enable=True, dtype="bfloat16", level="O2"):
        on = model.model(ids)
    assert off.dtype == on.dtype == torch.float32 and torch.equal(off, on)
    torch.manual_seed(0)
    plain = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    assert plain.model(ids).dtype == torch.bfloat16
