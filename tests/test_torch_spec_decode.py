"""The port's speculative decoding held to its contracts and to paddle_tpu
on the CPU: the port of tests/test_spec_decode.py (without the GPT case,
the D16 audit and the metrics registry, which wait for their ROADMAP
items).

The oracle is greedy parity: a speculating paged engine emits exactly the
non-speculating engine's tokens (tiny LLaMA in f32: MHA, GQA, an int8 KV
cache, the n-gram proposer, a draft model that is the target itself and
one that is not, a proposer that is always rejected), and the same tokens
as the reference's speculating engine, with the same window and
acceptance counts (also at an int4 KV cache). Besides: the n-gram proposer against the reference's;
the rejection sampler's emitted marginal within 0.03 of the target
distribution, seeded determinism and the greedy rows' accept rule; cache
rewind (published prefix blocks equal to a plain run's to f32 rounding, a
prefix hit after a speculative run token-identical); mixed speculating and
opted-out slots, an eos inside a window, a deadline during a verify
window; TPOT observed once per emitted token; the static engine's
speculative loop; SpecConfig's validation and FLAGS_spec_decode.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.inference import speculative as ref_spec
from paddle_tpu.text.models import LlamaConfig as RConfig
from paddle_tpu.text.models import LlamaForCausalLM as RLlama

from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.inference.engine import ServingEngine, _verify_tokens
from paddle_tpu_torch.inference.speculative import (AlwaysRejectProposer,
                                                    NgramProposer,
                                                    ReplayProposer,
                                                    SpecConfig,
                                                    propose_ngram)
from paddle_tpu_torch.text.models import (LlamaConfig, LlamaForCausalLM,
                                          llama_from_numpy)

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


def _tiny(kv_heads=None):
    return _pair(kv_heads)[1]


def _repetitive(vocab=128, motif=4, tiles=5, seed=0):
    rs = np.random.RandomState(seed)
    return np.tile(rs.randint(0, vocab, (motif,)), tiles).astype("int64")


def _engine(model, spec, **kw):
    return ServingEngine(model, max_slots=2, spec_decode=spec, device="cpu",
                         **kw)


def _drive(model, prompts, spec, nt=24, engine_kw=None, **req_kw):
    """Run one engine over `prompts`; (per-prompt outputs, engine)."""
    eng = _engine(model, spec, **(engine_kw or {}))
    rids = [eng.add_request(p, max_new_tokens=nt, **req_kw)
            for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], eng


# ------------------------------------------------------ n-gram proposal

def test_tiled_motif_full_k():
    assert propose_ngram(np.tile([7, 3, 9, 5], 6), 4).tolist() \
        == [7, 3, 9, 5]


def test_prefers_full_continuation_over_latest():
    ctx = np.tile([1, 2, 3, 4, 5, 6, 7, 8], 3)[:-4]
    assert len(propose_ngram(ctx, 6)) == 6


def test_no_match_and_short_context_are_empty():
    assert propose_ngram(np.arange(20), 4).size == 0
    assert propose_ngram(np.array([5]), 4).size == 0


def test_ngram_matches_reference_proposer():
    rs = np.random.RandomState(4)
    for _ in range(200):
        ctx = rs.randint(0, 6, (int(rs.randint(1, 40)),))
        k, g = int(rs.randint(1, 7)), int(rs.randint(1, 4))
        np.testing.assert_array_equal(propose_ngram(ctx, k, g),
                                      ref_spec.propose_ngram(ctx, k, g))


# --------------------------------------------------------- greedy parity

def _check_parity(model, spec, **engine_kw):
    prompts = [_repetitive(seed=s) for s in (0, 1)]
    base, _ = _drive(model, prompts, None, engine_kw=engine_kw)
    out, eng = _drive(model, prompts, spec, engine_kw=engine_kw)
    assert eng.spec_stats()["windows"] > 0, \
        "the engine never speculated: parity held vacuously"
    for b, o in zip(base, out):
        np.testing.assert_array_equal(o, b)
    return eng


@pytest.mark.parametrize("case", ["llama", "gqa", "int8_kv"])
def test_ngram_greedy_parity(case):
    model = _tiny(2 if case == "gqa" else None)
    kw = {"kv_cache_dtype": case[:4]} if case.endswith("kv") else {}
    eng = _check_parity(model, "ngram", **kw)
    assert eng.spec_stats()["accepted_tokens"] > 0


def test_draft_model_self_accepts_all():
    # the target as its own draft: proposals are the argmax stream, so
    # every window accepts all K
    model = _tiny()
    eng = _check_parity(model, SpecConfig(method="draft", k=4,
                                          draft_model=model))
    assert eng.spec_stats()["accept_rate"] == pytest.approx(1.0)


def test_draft_model_distinct_parity():
    torch.manual_seed(3)
    draft = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=64), device="cpu")
    _check_parity(_tiny(), SpecConfig(method="draft", k=3,
                                      draft_model=draft))
    wrong = LlamaForCausalLM(LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=64), device="cpu")
    eng = _engine(_tiny(), SpecConfig(method="draft", k=3,
                                      draft_model=wrong))
    eng.add_request(_repetitive(), max_new_tokens=4)
    with pytest.raises(ValueError, match="vocab"):
        eng.run()


def test_always_reject_parity_via_correction():
    eng = _check_parity(_tiny(), SpecConfig(proposer=AlwaysRejectProposer(4)))
    assert eng.spec_stats()["accept_rate"] < 0.2


@pytest.mark.parametrize("kv", ["model", "int4"])
def test_token_identity_with_reference_speculating_engine(kv):
    """The port's speculating engine against the reference's on the same
    stream: tokens, windows and acceptance equal, at the model's dtype
    and at an int4 KV cache (whose blocks a window requantizes, so that
    its tokens need not be a plain engine's: the reference's run is the
    oracle there)."""
    ref, port = _pair()
    prompts = [_repetitive(seed=s) for s in (0, 1, 2)]
    a = ref_engine.ServingEngine(ref, max_slots=2, spec_decode="ngram",
                                 kv_cache_dtype=kv)
    b = _engine(port, "ngram", kv_cache_dtype=kv)
    for p in prompts:
        assert a.add_request(p, max_new_tokens=20) \
            == b.add_request(p, max_new_tokens=20)
    want, got = a.run(), b.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    sa, sb = a.spec_stats(), b.spec_stats()
    for key in ("enabled", "k", "windows", "proposed_tokens",
                "accepted_tokens"):
        assert sb[key] == sa[key], key
    for key in ("steps", "decode_tokens", "spec_windows",
                "spec_proposed_tokens", "spec_accepted_tokens",
                "spec_accept_rate"):
        assert b.stats()[key] == a.stats()[key], key


# ---------------------------------------------------- rejection sampling

def _samp(b, do_sample, temperature=1.0, top_k=0, top_p=1.0):
    return {"do_sample": torch.as_tensor(do_sample),
            "temperature": torch.full((b,), temperature),
            "top_k": torch.full((b,), top_k, dtype=torch.int32),
            "top_p": torch.full((b,), top_p)}


def test_output_marginal_matches_target():
    # accept-or-resample leaves the emitted marginal equal to the target
    # distribution whatever the (deterministic) draft proposed
    rs = np.random.RandomState(0)
    b, v = 4000, 8
    lg = torch.from_numpy(rs.randn(b, 2, v).astype(np.float32))
    proposed = torch.from_numpy(rs.randint(0, v, (b, 1)))
    gen = torch.Generator().manual_seed(0)
    acc, tgt = _verify_tokens(lg, proposed,
                              (True, _samp(b, [True] * b), gen))
    emitted = np.where(acc[:, 0].numpy(), proposed[:, 0].numpy(),
                       tgt[:, 0].numpy())
    emp = np.bincount(emitted, minlength=v) / b
    exp = torch.softmax(lg[:, 0], dim=-1).mean(0).numpy()
    assert np.abs(emp - exp).max() < 0.03, (emp, exp)


def test_seeded_determinism_and_greedy_rows():
    rs = np.random.RandomState(1)
    b, v = 8, 16
    lg = torch.from_numpy(rs.randn(b, 3, v).astype(np.float32))
    proposed = torch.from_numpy(rs.randint(0, v, (b, 2)))
    samp = _samp(b, [True, False] * 4, 0.9, 5, 0.95)
    runs = [_verify_tokens(lg, proposed,
                           (True, samp, torch.Generator().manual_seed(7)))
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    greedy = lg.argmax(dim=-1)
    a1, t1 = runs[0]
    for i in range(1, b, 2):
        assert torch.equal(a1[i], proposed[i] == greedy[i, :2])
        assert torch.equal(t1[i], greedy[i])
    # a greedy program (any_sample False) is the bare accept rule
    a0, t0 = _verify_tokens(lg, proposed)
    assert torch.equal(a0, proposed == greedy[:, :2])
    assert torch.equal(t0, greedy)


def test_sampled_spec_run_drains():
    out, eng = _drive(_tiny(), [_repetitive()], "ngram", nt=12,
                      do_sample=True, temperature=0.8, top_k=20)
    assert len(out[0]) == 12
    assert eng.spec_stats()["windows"] > 0


# ----------------------------------------------------------- cache rewind

def test_prefix_cache_bit_identical():
    """Rejected candidates' K/V never reach registered prefix blocks: the
    published blocks after a speculative run equal the plain run's. Equal
    to f32 rounding (1e-6 of the largest |value|), not to the bit: a
    verify window computes a block's K/V in a [B * (k + 1), H] product and
    a decode tick in a [B, H] one, which may round differently (the
    reference's too: its bit-for-bit form of this check can fail on a
    CPU's f32 products); a leaked rejected candidate would differ by
    O(1)."""
    model = _tiny()
    prompt = _repetitive()
    engs = {}
    for tag, spec in (("plain", None), ("spec", "ngram")):
        eng = _engine(model, spec)
        eng.add_request(prompt, max_new_tokens=24)
        eng.run()
        engs[tag] = eng
    pc_p, pc_s = engs["plain"].prefix_cache, engs["spec"].prefix_cache
    assert engs["spec"].spec_stats()["windows"] > 0
    shared = set(pc_p._map) & set(pc_s._map)
    assert shared, "no common registered prefix blocks to compare"
    for h in shared:
        bp, bs_ = pc_p._map[h], pc_s._map[h]
        for t in ("k", "v"):
            want = getattr(engs["plain"].cache, t)[:, bp]
            torch.testing.assert_close(
                getattr(engs["spec"].cache, t)[:, bs_], want, rtol=0,
                atol=1e-6 * float(want.abs().max()))


def test_prefix_hit_after_spec_run_stays_token_identical():
    eng = _engine(_tiny(), "ngram")
    prompt = _repetitive()
    r1 = eng.add_request(prompt, max_new_tokens=24)
    eng.run()
    r2 = eng.add_request(prompt, max_new_tokens=24)
    out = eng.run()
    assert eng.prefix_cache.hits > 0
    np.testing.assert_array_equal(out[r1], out[r2])


# ------------------------------------------------------------- scheduling

def test_mixed_spec_and_optout_slots():
    model = _tiny()
    prompt = _repetitive()
    eng = _engine(model, "ngram")
    r_spec = eng.add_request(prompt, max_new_tokens=16)
    r_plain = eng.add_request(prompt, max_new_tokens=16, speculative=False)
    out = eng.run()
    assert eng.spec_stats()["windows"] > 0
    base, _ = _drive(model, [prompt], None, nt=16)
    np.testing.assert_array_equal(out[r_spec], base[0])
    np.testing.assert_array_equal(out[r_plain], base[0])


def test_mid_window_eos():
    model = _tiny()
    prompt = _repetitive()
    base, _ = _drive(model, [prompt], None, nt=16)
    eos = int(base[0][7])
    b_eos, _ = _drive(model, [prompt], None, nt=16, eos_token_id=eos)
    s_eos, eng = _drive(model, [prompt], "ngram", nt=16, eos_token_id=eos)
    np.testing.assert_array_equal(s_eos[0], b_eos[0])
    assert len(s_eos[0]) < 16          # eos cut the window
    assert list(eng.finish_reasons.values()) == ["eos"]


def test_timeout_during_verify_releases_blocks():
    eng = _engine(_tiny(), "ngram")
    free0 = eng.allocator.available
    r = eng.add_request(_repetitive(), max_new_tokens=40, max_time_ms=1.0)
    time.sleep(0.005)
    for _ in range(60):
        if not eng.has_work():
            break
        eng.step()
    assert eng.finish_reasons[r] == "timeout"
    assert eng.allocator.available == free0


# ------------------------------------------------------- TPOT accounting

def test_accepts_all_k4_observes_per_token():
    # K = 4 accepting all: each window emits 5 tokens; TPOT is observed
    # once per token at window wall / 5, not once per window
    model = _tiny()
    prompt = _repetitive()
    base, _ = _drive(model, [prompt], None, nt=20)
    eng = _engine(model, SpecConfig(proposer=ReplayProposer(4,
                                                            {0: base[0]})))
    r = eng.add_request(prompt, max_new_tokens=20)
    out = eng.run()
    ss = eng.spec_stats()
    np.testing.assert_array_equal(out[r], base[0])
    assert ss["accept_rate"] == pytest.approx(1.0)
    # the prefill emits the first of the 20: 19 decode tokens
    assert eng._m_tpot.count == eng.stats()["decode_tokens"] == 19
    assert eng._m_decode_step.count == ss["windows"]
    assert ss["windows"] < 19
    assert eng._m_decode_step.sum == pytest.approx(
        eng.stats()["decode_time_s"])


def test_plain_engine_tpot_count_unchanged():
    _, eng = _drive(_tiny(), [_repetitive()], None, nt=12)
    assert eng._m_tpot.count == eng.stats()["decode_tokens"] == 11
    assert eng.spec_stats() == {"enabled": False, "k": 0, "windows": 0,
                                "proposed_tokens": 0, "accepted_tokens": 0,
                                "accept_rate": 0.0}


# --------------------------------------------------------- static engine

def test_static_ngram_parity():
    model = _tiny()
    prompt = torch.from_numpy(np.stack([_repetitive(seed=0),
                                        _repetitive(seed=5)]))
    base = model.generate(prompt, max_new_tokens=16)
    spec = model.generate(prompt, max_new_tokens=16, spec_decode="ngram")
    np.testing.assert_array_equal(spec.numpy(), base.numpy())
    eos = int(base[0, 20 + 6])
    np.testing.assert_array_equal(
        model.generate(prompt, max_new_tokens=16, spec_decode="ngram",
                       eos_token_id=eos).numpy(),
        model.generate(prompt, max_new_tokens=16,
                       eos_token_id=eos).numpy())


def test_static_spec_rejects_sampling():
    with pytest.raises(NotImplementedError):
        _tiny().generate(torch.zeros((1, 8), dtype=torch.long),
                         max_new_tokens=4, spec_decode="ngram",
                         do_sample=True)


# ------------------------------------------------------------- SpecConfig

def test_spec_config_validation():
    with pytest.raises(ValueError):
        SpecConfig(method="magic")
    with pytest.raises(ValueError):
        SpecConfig(k=0)
    with pytest.raises(ValueError):
        SpecConfig(method="draft")          # draft needs a model
    assert SpecConfig().k == 4 and SpecConfig(k=2).k == 2


def test_flag_selects_proposer():
    set_flags({"FLAGS_spec_decode": "ngram"})
    try:
        eng = ServingEngine(_tiny(), max_slots=2, device="cpu")
        assert isinstance(eng.proposer, NgramProposer)
        assert eng.spec_stats()["enabled"] and eng.spec_stats()["k"] == 4
    finally:
        set_flags({"FLAGS_spec_decode": "off"})
    assert ServingEngine(_tiny(), max_slots=2, device="cpu").proposer is None
    assert _engine(_tiny(), "off").proposer is None
