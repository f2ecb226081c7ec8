"""The port's LLaMA against paddle_tpu's, from the same weights.

paddle_tpu's random init is carried across as numpy through
`convert.llama_from_numpy`; full-sequence logits must match at <= 1e-4 in
f32 (both sides f32; the bound covers matmul summation order over a few
layers). paddle_tpu's Linear stores [in, out], so a missed transpose in
the carry-over fails here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM
from paddle_tpu.text.models.llama import llama_tiny_config as p_tiny

from paddle_tpu_torch.text.models import (LlamaConfig, llama_from_numpy,
                                          llama_tiny_config)


def _carry(pcfg, cfg):
    paddle.seed(0)
    ref = PLlamaForCausalLM(pcfg)
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    return ref, llama_from_numpy(cfg, state, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"num_key_value_heads": 2},
                                {"hidden_size": 48, "rope_theta": 500.0}],
                         ids=["mha", "gqa", "wide-theta"])
def test_logits_match_reference(kw):
    ref, port = _carry(p_tiny(**kw), llama_tiny_config(**kw))
    ids = np.random.RandomState(0).randint(0, 256, (2, 37))
    want = np.asarray(ref(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 37, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_tied_embeddings_match_reference():
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64, tie_word_embeddings=True)
    ref, port = _carry(PLlamaConfig(**kw), LlamaConfig(**kw))
    assert port.lm_head is None
    ids = np.random.RandomState(1).randint(0, 64, (1, 20))
    want = np.asarray(ref(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = port(ids).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_carry_over_rejects_wrong_state():
    cfg = llama_tiny_config()
    _, port = _carry(p_tiny(), cfg)
    state = {"llama." + k[len("model."):] if k.startswith("model.") else k:
             v.numpy().T if "proj" in k or k == "lm_head.weight"
             else v.numpy()
             for k, v in port.state_dict().items()}
    llama_from_numpy(cfg, state, device="cpu")          # round trip loads
    missing = dict(state)
    missing.pop("lm_head.weight")
    with pytest.raises(RuntimeError):
        llama_from_numpy(cfg, missing, device="cpu")
    state["llama.layers.0.mlp.up_proj.weight"] = \
        state["llama.layers.0.mlp.up_proj.weight"].T   # untransposed
    with pytest.raises(RuntimeError):
        llama_from_numpy(cfg, state, device="cpu")


def test_rope_tables_and_config_match_reference():
    from paddle_tpu.text.generation import _rope_tables_np as p_rope
    from paddle_tpu_torch.text.generation import _rope_tables_np

    for args in ((64, 16, 10000.0, "float32"), (33, 128, 500000.0,
                                                "float32")):
        for a, b in zip(_rope_tables_np(*args), p_rope(*args)):
            np.testing.assert_array_equal(a, b)
    assert llama_tiny_config().head_dim == p_tiny().head_dim
    assert LlamaConfig(num_attention_heads=8).num_key_value_heads == 8
