"""The port's paged serving engine against paddle_tpu's (the reference).

Greedy token identity with paddle_tpu's ServingEngine (prefix cache off,
whole-prompt prefill) on a mixed stream with more requests than slots, for
MHA and GQA tiny LLaMA; `generate_paged` identity; sampling-filter parity;
seeded sampling determinism; and the scheduler contracts of
tests/test_serving.py (allocator, admission control, block release,
static waves) plus deadlines and the options the port refuses.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax.numpy as jnp
from paddle_tpu.inference import engine as jax_engine
from paddle_tpu.text import paged_cache as jax_cache
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM

from paddle_tpu_torch.inference.engine import (ServingEngine, _filter_logits,
                                               generate_paged)
from paddle_tpu_torch.text import paged_cache as port_cache
from paddle_tpu_torch.text.models import LlamaConfig, llama_from_numpy

_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)


def _pair(kv_heads=None, max_pos=64):
    """The same tiny LLaMA in both packages: paddle_tpu's random init,
    carried across as numpy."""
    kw = dict(_KW, num_key_value_heads=kv_heads,
              max_position_embeddings=max_pos)
    paddle.seed(0)
    ref = PLlamaForCausalLM(PLlamaConfig(**kw))
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    return ref, llama_from_numpy(LlamaConfig(**kw), state, device="cpu")


def _port(**kw):
    return _pair(**kw)[1]


_STREAM = ((3, 4), (7, 6), (2, 9), (5, 3), (4, 5), (11, 4))


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_greedy_token_identity_with_reference_engine(kv_heads):
    ref, port = _pair(kv_heads=kv_heads)
    a = jax_engine.ServingEngine(ref, max_slots=2, kv_block_size=8,
                                 prefix_cache=False,
                                 chunked_prefill_tokens=0)
    b = ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu")
    rs = np.random.RandomState(3)
    for ln, nt in _STREAM:
        p = rs.randint(0, 128, (ln,))
        assert a.add_request(p, max_new_tokens=nt) \
            == b.add_request(p, max_new_tokens=nt)
    want, got = a.run(), b.run()
    assert sorted(want) == sorted(got) == list(range(len(_STREAM)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    sa, sb = a.stats(), b.stats()
    for key in ("steps", "decode_tokens", "prefill_tokens",
                "slot_utilization", "requests_completed", "kv_pool_blocks",
                "kv_pool_free"):
        assert sb[key] == sa[key], key


def test_generate_paged_and_model_generate_identity():
    ref, port = _pair()
    prompt = np.random.RandomState(0).randint(0, 128, (2, 5))
    want = jax_engine.generate_paged(ref, prompt, 6, prefix_cache=False)
    got = generate_paged(port, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got, want)
    full = port.generate(torch.from_numpy(prompt), max_new_tokens=6,
                         engine="paged")
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(ref.generate(
            paddle.to_tensor(prompt), max_new_tokens=6, engine="paged",
            prefix_cache=False)._data))


def test_eos_finishes_and_pads_like_reference():
    ref, port = _pair()
    prompt = np.random.RandomState(4).randint(0, 128, (1, 4))
    first = int(generate_paged(port, prompt, 1, device="cpu")[0, 0])
    got = generate_paged(port, prompt, 8, eos_token_id=first, device="cpu")
    want = jax_engine.generate_paged(ref, prompt, 8, eos_token_id=first,
                                     prefix_cache=False)
    np.testing.assert_array_equal(got, want)
    assert (got[0] == first).all()
    out = port.generate(torch.from_numpy(prompt), max_new_tokens=8,
                        engine="paged", eos_token_id=first)
    assert tuple(out.shape) == (1, 5)


def test_filter_logits_matches_reference():
    rs = np.random.RandomState(1)
    logits = rs.randn(6, 50).astype("float32") * 3
    temp = np.array([1.0, 0.5, 2.0, 1.0, 0.7, 1.3], "float32")
    top_k = np.array([0, 5, 0, 10, 3, 50], "int32")
    top_p = np.array([1.0, 1.0, 0.8, 0.5, 0.9, 0.3], "float32")
    want = np.asarray(jax_engine._filter_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = _filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                         torch.from_numpy(top_k),
                         torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_seeded_sampling_is_deterministic():
    port = _port()
    prompt = np.random.RandomState(5).randint(0, 128, (2, 6))
    kw = dict(do_sample=True, temperature=1.5, top_k=20, device="cpu")
    s1 = generate_paged(port, prompt, 8, seed=7, **kw)
    s2 = generate_paged(port, prompt, 8, seed=7, **kw)
    s3 = generate_paged(port, prompt, 8, seed=8, **kw)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(s1, s3)
    assert ((s1 >= 0) & (s1 < 128)).all()


def test_mixed_greedy_and_sampled_rows_keep_greedy_exact():
    port = _port()
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 128, (5,)), rs.randint(0, 128, (7,))]
    alone = ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu")
    rid = alone.add_request(prompts[0], max_new_tokens=6)
    want = alone.run()[rid]
    mixed = ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu")
    g = mixed.add_request(prompts[0], max_new_tokens=6)
    mixed.add_request(prompts[1], max_new_tokens=6, do_sample=True,
                      temperature=1.2, top_p=0.9)
    np.testing.assert_array_equal(mixed.run()[g], want)


# ------------------------------------------------------ paged cache rules

def test_append_and_scatter_match_reference():
    rs = np.random.RandomState(2)
    pool = rs.randn(2, 9, 2, 8, 4).astype("float32")     # [L, N, Hkv, bs, D]
    ks = rs.randn(2, 16, 2, 4).astype("float32")         # [L, S, Hkv, D]
    row = np.array([3, 5, 7, 0], "int32")
    want = np.asarray(jax_cache.scatter_prefill(
        jnp.asarray(pool), jnp.asarray(ks), 11, jnp.asarray(row), 8))
    got = port_cache.scatter_prefill(torch.from_numpy(pool.copy()),
                                     torch.from_numpy(ks), 11,
                                     torch.from_numpy(row), 8).numpy()
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])  # 0 = trash
    kv = rs.randn(3, 2, 4).astype("float32")
    blk = np.array([4, 6, 0], "int32")
    off = np.array([1, 7, 0], "int32")
    want = np.asarray(jax_cache.append_token(
        jnp.asarray(pool[0]), jnp.asarray(kv), jnp.asarray(blk),
        jnp.asarray(off)))
    cache = torch.from_numpy(pool[0].copy())
    port_cache.append_token(cache, torch.from_numpy(kv),
                            torch.from_numpy(blk), torch.from_numpy(off))
    np.testing.assert_array_equal(cache.numpy(), want)


class TestAllocator:
    def test_alloc_free_roundtrip(self):
        a = port_cache.BlockAllocator(8)
        assert a.available == 7
        ids = a.alloc(3)
        assert len(ids) == 3 and 0 not in ids
        a.free(ids)
        assert a.available == 7

    def test_all_or_nothing(self):
        a = port_cache.BlockAllocator(4)
        assert a.alloc(5) is None
        assert a.available == 3

    def test_double_free_and_trash_guard(self):
        a = port_cache.BlockAllocator(4)
        ids = a.alloc(2)
        a.free(ids)
        with pytest.raises(ValueError):
            a.free([ids[0]])
        with pytest.raises(ValueError):
            a.free([0])

    def test_blocks_for(self):
        for n in (1, 16, 17, 100):
            assert port_cache.blocks_for(n, 16) == jax_cache.blocks_for(n, 16)

    def test_cache_block_size_alignment(self):
        with pytest.raises(ValueError):
            port_cache.PagedKVCache(1, 4, 2, 12, 16, torch.float32, "cpu")


# --------------------------------------------------------- the scheduler

class TestContinuousBatching:
    def test_slots_refill_mid_flight(self):
        eng = ServingEngine(_port(), max_slots=2, kv_block_size=8,
                            device="cpu")
        rs = np.random.RandomState(3)
        want = {}
        for ln, nt in ((3, 4), (7, 6), (2, 9), (5, 3), (4, 5)):
            want[eng.add_request(rs.randint(0, 128, (ln,)),
                                 max_new_tokens=nt)] = nt
        refilled = False
        while eng.has_work():
            before = eng.num_active
            eng.step()
            if 0 < before < 2 and eng.num_active == 2:
                refilled = True
        assert {r: len(v) for r, v in eng.completed.items()} == want
        assert refilled, "no slot was refilled mid-flight"
        st = eng.stats()
        assert st["slot_utilization"] > 0.8
        assert len(st["ttft_s"]) == 5 and len(st["queue_wait_s"]) == 5
        assert st["requests_completed"] == 5

    def test_admission_control_against_pool(self):
        eng = ServingEngine(_port(), max_slots=2, kv_block_size=8,
                            num_kv_blocks=6, device="cpu")
        rs = np.random.RandomState(4)
        big = eng.add_request(rs.randint(0, 128, (30,)), max_new_tokens=10)
        small = eng.add_request(rs.randint(0, 128, (4,)), max_new_tokens=4)
        eng.step()
        assert eng.num_active == 1 and eng.num_waiting == 1
        done = eng.run()
        assert len(done[big]) == 10 and len(done[small]) == 4

    def test_impossible_request_rejected(self):
        eng = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                            num_kv_blocks=3, device="cpu")
        with pytest.raises(ValueError):            # pool can never cover
            eng.add_request(np.arange(30) % 16, max_new_tokens=10)
        with pytest.raises(ValueError):            # context too small
            eng.add_request(np.arange(60) % 16, max_new_tokens=60)
        with pytest.raises(ValueError):
            eng.add_request([], max_new_tokens=2)

    def test_blocks_released_on_finish(self):
        eng = ServingEngine(_port(), max_slots=2, kv_block_size=8,
                            num_kv_blocks=9, device="cpu")
        free0 = eng.allocator.available
        rs = np.random.RandomState(5)
        eng.add_request(rs.randint(0, 128, (5,)), max_new_tokens=4)
        eng.add_request(rs.randint(0, 128, (9,)), max_new_tokens=6)
        eng.run()
        assert eng.allocator.available == free0
        assert eng.stats()["kv_pool_free"] == free0
        assert eng.num_active == 0 and eng.num_waiting == 0

    def test_static_admission_is_waves(self):
        eng = ServingEngine(_port(), max_slots=2, kv_block_size=8,
                            admission="static", device="cpu")
        rs = np.random.RandomState(6)
        for ln, nt in ((3, 3), (4, 8), (5, 4)):
            eng.add_request(rs.randint(0, 128, (ln,)), max_new_tokens=nt)
        while eng.has_work():
            before = eng.num_active
            eng.step()
            assert not (before not in (0, 2) and eng.num_active > before)
        assert len(eng.completed) == 3

    def test_deadline_finishes_with_timeout(self):
        eng = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                            device="cpu")
        free0 = eng.allocator.available
        rs = np.random.RandomState(7)
        running = eng.add_request(rs.randint(0, 128, (4,)),
                                  max_new_tokens=40, max_time_ms=200)
        queued = eng.add_request(rs.randint(0, 128, (4,)),
                                 max_new_tokens=4, max_time_ms=1)
        eng.step()                      # admits `running`, queues `queued`
        time.sleep(0.25)
        events = eng.step()
        assert (running, None, True) in events
        assert (queued, None, True) in events
        assert eng.finish_reasons == {running: "timeout", queued: "timeout"}
        assert 1 <= len(eng.completed[running]) < 40
        assert len(eng.completed[queued]) == 0
        assert eng.allocator.available == free0
        assert not eng.has_work()

    def test_warmup_state(self):
        eng = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                            device="cpu")
        assert not eng.warmed
        assert eng.finish_warmup() is eng and eng.warmed


@pytest.mark.parametrize("kwargs", [
    {"prefix_cache": True}, {"chunked_prefill_tokens": 16},
    {"prefix_cache_max_blocks": 4}, {"spec_decode": "ngram"},
    {"weight_quant": "int8"}, {"weight_quant": "int4"},
    {"kv_cache_dtype": "int8"}, {"kv_cache_dtype": "int4"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(_port(), max_slots=1, device="cpu", **kwargs)


def test_bad_options_and_static_engine_raise():
    port = _port()
    with pytest.raises(ValueError):
        ServingEngine(port, weight_quant="int2", device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(port, admission="waves", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.generate(np.zeros((1, 4), "int64"), max_new_tokens=2)
    with pytest.raises(ValueError):
        port.generate(np.zeros((1, 4), "int64"), max_new_tokens=2,
                      engine="vllm")


def test_block_rounded_context_gap_raises_at_api():
    port = _pair(max_pos=40)[1]
    prompt = np.random.RandomState(11).randint(0, 128, (1, 30))
    with pytest.raises(ValueError, match="usable context"):
        port.generate(prompt, max_new_tokens=5, engine="paged")
