"""The port's models as `nn.Layer`s with the reference's `state_dict`
(ROADMAP.md Queue 1 item 11), held to paddle_tpu's on the CPU.

Tiny LLaMAs (MHA, GQA, tied embeddings), a tiny GPT and a tiny BERT
classifier (dropout 0): the reference's state dict, as numpy, loads into
the port's model by `set_state_dict` with no transposes and nothing
missing or left over; keys, shapes and dtypes are the reference's and
the naming rule's (`convert.state_dict_shapes`); every parameter is the
Tensor API's `Parameter`; a `paddle.save` file of either package
restores the same logits in the other. Logits, loss and gradients
against the reference (f32, both flags) are in
test_torch_models_layer_grads.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import bert as rbert
from paddle_tpu.text.models import gpt as rgpt
from paddle_tpu.text.models import llama as rllama

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.text.models import (
    BertConfig, BertForSequenceClassification, GPTConfig, GPTForCausalLM,
    LlamaForCausalLM, llama_tiny_config)
from paddle_tpu_torch.text.models.convert import state_dict_shapes

GPT_TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=64)
BERT_TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 hidden_dropout_prob=0.0)
ARCHS = ["llama-mha", "llama-gqa", "llama-tied", "gpt", "bert"]
_LLAMA_KW = {"llama-mha": {}, "llama-gqa": {"num_key_value_heads": 2},
             "llama-tied": {"tie_word_embeddings": True}}


def build(arch, seed=0):
    """(reference model, port config, port model class) of `arch`, the
    reference built from `paddle.seed(seed)`."""
    paddle.seed(seed)
    if arch.startswith("llama"):
        kw = _LLAMA_KW[arch]
        return (rllama.LlamaForCausalLM(rllama.llama_tiny_config(**kw)),
                llama_tiny_config(**kw), LlamaForCausalLM)
    if arch == "gpt":
        return (rgpt.GPTForCausalLM(rgpt.GPTConfig(**GPT_TINY)),
                GPTConfig(**GPT_TINY), GPTForCausalLM)
    return (rbert.BertForSequenceClassification(rbert.BertConfig(
        **BERT_TINY)), BertConfig(**BERT_TINY),
        BertForSequenceClassification)


def numpy_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def carried(arch, seed=0):
    """(reference, port) holding the same weights, carried by
    set_state_dict with no transposes."""
    ref, cfg, cls = build(arch, seed)
    port = cls(cfg, device="cpu")
    missing, unexpected = port.set_state_dict(numpy_state(ref))
    assert not missing and not unexpected
    return ref, port


def ids_for(arch, seed=3):
    return np.random.RandomState(seed).randint(0, 64, (2, 19))


def logits(model, ids, pkg):
    out = model(pkg.to_tensor(ids))
    if isinstance(out, tuple):
        out = out[0]
    return np.asarray(out._data, dtype="float32") if pkg is paddle \
        else out.numpy()


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_state_loads_without_transposes(arch):
    """The reference's arrays go in as they are and come back bit for
    bit through `state_dict`."""
    ref, port = carried(arch)
    state = numpy_state(ref)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_keys_shapes_dtypes_equal_reference(arch):
    ref, cfg, cls = build(arch)
    torch.manual_seed(0)
    port = cls(cfg, device="cpu")
    want = [(k, list(v.shape), str(v.dtype))
            for k, v in ref.state_dict().items()]
    got = [(k, v.shape, str(v.dtype)) for k, v in port.state_dict().items()]
    assert got == want
    assert [(k, s) for k, s, _ in want] == state_dict_shapes(cfg)
    assert all(isinstance(p, pt.Parameter) and not p.stop_gradient
               for p in port.parameters())
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]


def test_llama_rope_tables_stay_out_of_the_state_dict():
    """The rope tables are non-persistable buffers: in `buffers()`, not in
    `state_dict`, as the reference keeps them out; `llama` and `model`
    name one sublayer."""
    _, port = carried("llama-mha")
    names = {n for n, _ in port.named_buffers()}
    assert names == {"llama.rope_cos", "llama.rope_sin"}
    assert not any("rope" in k for k in port.state_dict())
    assert port.llama is port.model


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    """paddle.save of the port's state dict, paddle_tpu.load +
    set_state_dict into a reference model built from another seed: the
    reference's logits equal the port's."""
    _, port = carried(arch)
    ids = ids_for(arch)
    path = str(tmp_path / "model.pdparams")
    pt.save(port.state_dict(), path)
    other, _, _ = build(arch, seed=7)
    other.set_state_dict(paddle.load(path))
    other.eval()
    port.eval()
    with torch.no_grad():
        want = logits(port, ids, pt)
    np.testing.assert_allclose(logits(other, ids, paddle), want, atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    """paddle_tpu.save of the reference's state dict, paddle.load +
    set_state_dict into a port model built from another seed: the port's
    logits equal the reference's."""
    ref, cfg, cls = build(arch)
    path = str(tmp_path / "model.pdparams")
    paddle.save(ref.state_dict(), path)
    torch.manual_seed(7)
    port = cls(cfg, device="cpu")
    missing, unexpected = port.set_state_dict(pt.load(path))
    assert not missing and not unexpected
    ids = ids_for(arch)
    ref.eval()
    port.eval()
    with torch.no_grad():
        got = logits(port, ids, pt)
    np.testing.assert_allclose(got, logits(ref, ids, paddle), atol=1e-4,
                               rtol=0)


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
