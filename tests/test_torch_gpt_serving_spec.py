"""GPT speculative decoding in the port held to paddle_tpu on the CPU.

Tiny GPT (vocab 96, hidden 32, 2 layers, 4 heads, 64 positions, f32),
paddle_tpu's seeded init carried across by `gpt_from_numpy`. The port of
the reference's `test_gpt_ngram`: an n-gram speculating engine emits the
plain engine's tokens and the reference's speculating engine's, with the
same windows and acceptance; a GPT target that is its own draft accepts
every window; a LLaMA draft of the same vocabulary serves a GPT target
(the pairing the reference serves); verify windows at the context's end,
whose positions run past the wpe table and are clamped, as the
reference's; the static engine's speculative loop on GPT.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.inference import speculative as ref_spec
from paddle_tpu.text.models import LlamaConfig as RLConfig
from paddle_tpu.text.models import LlamaForCausalLM as RLlama
from paddle_tpu.text.models.gpt import GPTConfig as RConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RGPT

from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.text.models import (GPTConfig, LlamaConfig,
                                          gpt_from_numpy, llama_from_numpy)

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


def _repetitive(motif=4, tiles=5, seed=0):
    rs = np.random.RandomState(seed)
    return np.tile(rs.randint(0, 96, (motif,)), tiles).astype("int64")


def _drive(model, prompts, spec, nt=24):
    eng = ServingEngine(model, max_slots=2, spec_decode=spec, device="cpu")
    rids = [eng.add_request(p, max_new_tokens=nt) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], eng


def _check_parity(model, spec):
    prompts = [_repetitive(seed=s) for s in (0, 1)]
    base, _ = _drive(model, prompts, None)
    out, eng = _drive(model, prompts, spec)
    assert eng.spec_stats()["windows"] > 0, \
        "the engine never speculated: parity held vacuously"
    for b, o in zip(base, out):
        np.testing.assert_array_equal(o, b)
    return eng


def test_gpt_ngram_parity_and_reference_identity():
    ref, port = _pair()
    _check_parity(port, "ngram")
    prompts = [_repetitive(seed=s) for s in (0, 1, 2)]
    a = ref_engine.ServingEngine(ref, max_slots=2, spec_decode="ngram")
    b = ServingEngine(port, max_slots=2, spec_decode="ngram", device="cpu")
    for p in prompts:
        a.add_request(p, max_new_tokens=20)
        b.add_request(p, max_new_tokens=20)
    want, got = a.run(), b.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for key in ("windows", "proposed_tokens", "accepted_tokens"):
        assert b.spec_stats()[key] == a.spec_stats()[key], key


def test_gpt_target_as_its_own_draft_accepts_every_window():
    _, port = _pair()
    eng = _check_parity(port, SpecConfig(method="draft", k=4,
                                         draft_model=port))
    assert eng.spec_stats()["accept_rate"] == pytest.approx(1.0)


def test_llama_draft_serves_a_gpt_target_as_the_reference():
    """Mixed archs with one vocabulary: the reference serves the pairing
    (the draft has its own spec and cache); tokens and acceptance equal
    its run, and the plain engine's."""
    ref, port = _pair()
    lkw = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
               num_hidden_layers=1, num_attention_heads=2,
               max_position_embeddings=64)
    paddle.seed(3)
    rdraft = RLlama(RLConfig(**lkw))
    rdraft.eval()
    state = {k: np.asarray(v._data) for k, v in rdraft.state_dict().items()}
    pdraft = llama_from_numpy(LlamaConfig(**lkw), state, device="cpu")
    _check_parity(port, SpecConfig(method="draft", k=3, draft_model=pdraft))
    prompts = [_repetitive(seed=s) for s in (0, 1)]
    a = ref_engine.ServingEngine(ref, max_slots=2, spec_decode=(
        ref_spec.SpecConfig(method="draft", k=3, draft_model=rdraft)))
    b = ServingEngine(port, max_slots=2, device="cpu", spec_decode=(
        SpecConfig(method="draft", k=3, draft_model=pdraft)))
    for p in prompts:
        a.add_request(p, max_new_tokens=16)
        b.add_request(p, max_new_tokens=16)
    want, got = a.run(), b.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for key in ("windows", "proposed_tokens", "accepted_tokens"):
        assert b.spec_stats()[key] == a.spec_stats()[key], key


def test_verify_windows_at_the_context_end():
    """Requests whose last window reaches max_model_len (64): a window
    at position 60 with k 4 scores positions to 64, past the 64-row wpe
    table; clamped on both sides, the tokens equal the reference's."""
    ref, port = _pair()
    prompts = [(_repetitive(tiles=12, seed=4), 16),
               (_repetitive(tiles=14, seed=5), 8)]
    a = ref_engine.ServingEngine(ref, max_slots=2, kv_block_size=8,
                                 spec_decode="ngram")
    b = ServingEngine(port, max_slots=2, kv_block_size=8,
                      spec_decode="ngram", device="cpu")
    for p, n in prompts:
        assert p.size + n == 64
        a.add_request(p, max_new_tokens=n)
        b.add_request(p, max_new_tokens=n)
    want, got = a.run(), b.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert b.spec_stats()["windows"] == a.spec_stats()["windows"] > 0


def test_static_engine_ngram_on_gpt():
    ref, port = _pair()
    prompt = np.stack([_repetitive(seed=s) for s in (0, 1)])
    plain = port.generate(torch.from_numpy(prompt), max_new_tokens=12)
    spec = port.generate(torch.from_numpy(prompt), max_new_tokens=12,
                         spec_decode="ngram")
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())
    want = np.asarray(ref.generate(paddle.to_tensor(prompt),
                                   max_new_tokens=12,
                                   spec_decode="ngram")._data)
    np.testing.assert_array_equal(spec.numpy(), want)
