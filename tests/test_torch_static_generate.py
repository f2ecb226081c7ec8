"""The port's static single-program `generate` held to paddle_tpu's on the
CPU.

Greedy token identity with the reference's static `generate` on tiny
LLaMA in f32, MHA and GQA, with weight_quant none, int8 and int4, at two
prompt buckets and with an eos that finishes the rows early; identity
with `engine="paged"`; a generation length that the bucket trims; seeded
sampling that repeats itself and stays inside the top-k filter; the
program cache (one program per key, reused); the refusals (context
past max_position_embeddings, prefix_cache with the static engine and
the static engine's speculative limits), and a GPT model taking the
static engine.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import LlamaConfig as RConfig
from paddle_tpu.text.models import LlamaForCausalLM as RLlama

from paddle_tpu_torch.text import generation
from paddle_tpu_torch.text.models import LlamaConfig, llama_from_numpy

_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
_PAIRS: dict = {}


def _pair(kv_heads=None):
    """The same tiny LLaMA in both packages (paddle_tpu's seeded init),
    built once per module."""
    if kv_heads not in _PAIRS:
        kw = dict(_KW, num_key_value_heads=kv_heads)
        paddle.seed(0)
        ref = RLlama(RConfig(**kw))
        ref.eval()
        state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
        _PAIRS[kv_heads] = (ref, llama_from_numpy(LlamaConfig(**kw), state,
                                                  device="cpu"))
    return _PAIRS[kv_heads]


def _prompt(b, s, seed):
    return np.random.RandomState(seed).randint(0, 128, (b, s))


def _ref_generate(ref, prompt, **kw):
    return np.asarray(ref.generate(paddle.to_tensor(prompt), **kw)._data)


@pytest.mark.parametrize("weight_quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_greedy_identity_with_reference_static(kv_heads, weight_quant):
    ref, port = _pair(kv_heads)
    # prompt buckets 8 and 16 (the quantized cases at 8: each key is a
    # reference compile), generation bucket 8
    cases = ((2, 5, 1), (2, 11, 2)) if weight_quant == "none" \
        else ((2, 5, 1),)
    for b, s, seed in cases:
        prompt = _prompt(b, s, seed)
        want = _ref_generate(ref, prompt, max_new_tokens=7,
                             weight_quant=weight_quant)
        got = port.generate(torch.from_numpy(prompt), max_new_tokens=7,
                            weight_quant=weight_quant)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_eos_and_paged_identity():
    ref, port = _pair()
    prompt = _prompt(2, 6, 3)
    full = port.generate(torch.from_numpy(prompt), max_new_tokens=9)
    np.testing.assert_array_equal(
        full.numpy(), port.generate(torch.from_numpy(prompt),
                                    max_new_tokens=9,
                                    engine="paged").numpy())
    eos = int(full[0, 6 + 4])
    want = _ref_generate(ref, prompt, max_new_tokens=9, eos_token_id=eos)
    got = port.generate(torch.from_numpy(prompt), max_new_tokens=9,
                        eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    paged = port.generate(torch.from_numpy(prompt), max_new_tokens=9,
                          eos_token_id=eos, engine="paged")
    np.testing.assert_array_equal(got.numpy(), paged.numpy())
    # max_length and a 1-D prompt
    one = port.generate(torch.from_numpy(prompt[0]), max_length=10)
    np.testing.assert_array_equal(one.numpy(), full.numpy()[:1, :10])


def test_generation_bucket_trims_and_programs_are_reused():
    ref, port = _pair()
    prompt = _prompt(1, 4, 4)
    generation._STATIC.pop(port, None)
    # 5 and 6 new tokens share the generation bucket 8 and prompt bucket 4
    for mnt in (5, 6):
        want = _ref_generate(ref, prompt, max_new_tokens=mnt)
        got = port.generate(torch.from_numpy(prompt), max_new_tokens=mnt)
        np.testing.assert_array_equal(got.numpy(), want)
    stats = generation.static_program_stats(port)
    assert stats["programs"] == 1
    assert stats["graphs"] == 0            # no card: the step runs eagerly


def test_seeded_sampling_repeats_and_stays_in_top_k():
    _, port = _pair()
    prompt = _prompt(2, 5, 5)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=3)
    a = port.generate(torch.from_numpy(prompt), seed=11, **kw).numpy()
    b = port.generate(torch.from_numpy(prompt), seed=11, **kw).numpy()
    np.testing.assert_array_equal(a, b)
    # each sampled token is among the top-3 of its teacher-forced logits
    with torch.no_grad():
        logits = port(torch.from_numpy(a[:, :-1]))
    top3 = torch.topk(logits[:, 4:], 3, dim=-1).indices.numpy()
    assert all(a[r, 5 + i] in top3[r, i] for r in range(2)
               for i in range(8))
    others = [port.generate(torch.from_numpy(prompt), seed=s, **kw).numpy()
              for s in (12, 13, 14)]
    assert any(not np.array_equal(a, o) for o in others)


def test_refusals():
    _, port = _pair()
    prompt = torch.from_numpy(_prompt(1, 8, 6))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port.generate(prompt, max_new_tokens=60)
    with pytest.raises(ValueError, match="paged"):
        port.generate(prompt, max_new_tokens=4, prefix_cache=True)
    with pytest.raises(ValueError, match="max_new_tokens"):
        port.generate(prompt, max_new_tokens=0)
    with pytest.raises(ValueError, match="weight_quant"):
        port.generate(prompt, max_new_tokens=2, weight_quant="int2")
    with pytest.raises(NotImplementedError, match="greedy-only"):
        port.generate(prompt, max_new_tokens=4, spec_decode="ngram",
                      do_sample=True)
    with pytest.raises(NotImplementedError, match="unquantized"):
        port.generate(prompt, max_new_tokens=4, spec_decode="ngram",
                      weight_quant="int8")
    from paddle_tpu_torch.inference.speculative import SpecConfig

    with pytest.raises(NotImplementedError, match="n-gram proposer only"):
        port.generate(prompt, max_new_tokens=4, spec_decode=SpecConfig(
            method="draft", draft_model=port))
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    gpt = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                   num_hidden_layers=1,
                                   num_attention_heads=2,
                                   max_position_embeddings=32),
                         device="cpu")
    # a GPT model takes the static engine (GPT serving is ported)
    short = prompt[:, :4] % 64
    out = generation.generate(gpt, short, max_new_tokens=2)
    assert out.shape == (short.shape[0], 6)
    np.testing.assert_array_equal(out[:, :4].numpy(), short)
