"""GPT serving in the port held to paddle_tpu on the CPU: quantized
weights and KV caches, the prefix cache with chunked prefill.

Tiny GPT (vocab 96, hidden 32, 2 layers, 4 heads, 64 positions, f32),
paddle_tpu's seeded init carried across by `gpt_from_numpy`. The
quantized serving params (qkv, o, fc_in, fc_out and the head as
weight-only int8 / int4 pairs) equal the reference's bit for bit; greedy
tokens equal the reference's through the static `generate` with int8
and int4 weights; on a shared-prefix stream with 8- and 16-token chunks
(copy-on-write included) the tokens and the prefix-cache counters equal
the reference's. The serving engine's quantized modes are held in
test_torch_gpt_serving_kv.py (another worker).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.text import generation as ref_gen
from paddle_tpu.text.models.gpt import GPTConfig as RConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RGPT

from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.text import generation
from paddle_tpu_torch.text.models import GPTConfig, gpt_from_numpy

_KW = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)
_PAIR: list = []


def _pair():
    """The same tiny GPT in both packages, built once per module."""
    if not _PAIR:
        paddle.seed(0)
        ref = RGPT(RConfig(**_KW))
        ref.eval()
        state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
        _PAIR.append((ref, gpt_from_numpy(GPTConfig(**_KW), state,
                                          device="cpu")))
    return _PAIR[0]


def _run_both(kw, prompts, engine_kw=None):
    """The same requests through both engines; returns (ref tokens, port
    tokens, ref engine, port engine)."""
    ref, port = _pair()
    ekw = dict(max_slots=2, kv_block_size=8, **(engine_kw or {}))
    a = ref_engine.ServingEngine(ref, **ekw, **kw)
    b = ServingEngine(port, device="cpu", **ekw, **kw)
    for p, n in prompts:
        assert a.add_request(p, max_new_tokens=n) \
            == b.add_request(p, max_new_tokens=n)
    return a.run(), b.run(), a, b


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_quantized_params_equal_reference(weight_quant):
    ref, port = _pair()
    rp = ref_gen._stacked_params_gpt(ref, weight_quant=weight_quant)
    pp = generation._extract_gpt(port, weight_quant)
    head = pp["lm_head"]
    assert isinstance(head, tuple)
    for got, want in zip(head, rp["lm_head"]):
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want))
    for i, lw in enumerate(pp["layers"]):
        for k, w in lw.items():
            want = rp["layers"][k]
            if k in ("qkv", "o", "fc_in", "fc_out"):
                assert isinstance(w, tuple), k
                for g, r in zip(w, want):
                    np.testing.assert_array_equal(g.detach().numpy(),
                                                  np.asarray(r[i]))
            else:
                np.testing.assert_array_equal(w.detach().numpy(),
                                              np.asarray(want[i]))


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_static_generate_quantized_identity(weight_quant):
    ref, port = _pair()
    prompt = np.random.RandomState(1).randint(0, 96, (2, 5))
    want = np.asarray(ref.generate(paddle.to_tensor(prompt),
                                   max_new_tokens=7,
                                   weight_quant=weight_quant)._data)
    got = port.generate(torch.from_numpy(prompt), max_new_tokens=7,
                        weight_quant=weight_quant)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [8, 16])
def test_prefix_cache_with_chunked_prefill_identity(chunk):
    """A shared 24-token system prompt behind unique suffixes, one whole
    repeat (a copy-on-write hit) and a long cold prompt: the chunk ladder
    at learned positions from each chunk's offset."""
    rs = np.random.RandomState(7)
    system = rs.randint(0, 96, (24,))
    first = np.concatenate([system, rs.randint(0, 96, (5,))])
    prompts = [(first, 4),
               (np.concatenate([system, rs.randint(0, 96, (9,))]), 5),
               (first, 3),
               (rs.randint(0, 96, (37,)), 4)]
    want, got, a, b = _run_both(dict(prefix_cache=True,
                                     chunked_prefill_tokens=chunk),
                                [prompts[0]])
    # the rest behind the first, which has registered its blocks
    for p, n in prompts[1:]:
        a.add_request(p, max_new_tokens=n)
        b.add_request(p, max_new_tokens=n)
    want, got = a.run(), b.run()
    assert sorted(want) == sorted(got) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    sa, sb = a.stats(), b.stats()
    for key in ("prefix_blocks_hit", "prefix_blocks_missed",
                "prefix_cached_blocks", "prefill_chunks", "prefill_tokens",
                "kv_pool_free"):
        assert sb[key] == sa[key], key
    assert sb["prefix_blocks_hit"] > 0
    assert b.prefix_cache.referenced_blocks == 0
