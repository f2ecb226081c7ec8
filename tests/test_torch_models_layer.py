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
test_torch_models_layer_grads*.py; recompute, the Tensor boundary and
the O2 rule in test_torch_models_layer_calls.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
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
