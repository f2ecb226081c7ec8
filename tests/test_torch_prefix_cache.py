"""The port's prefix cache and chunked prefill against paddle_tpu's.

The contracts of tests/test_prefix_cache.py, held against the reference
with the same inputs made from a seed: the hash chain (equal digests) and
the PrefixCache bookkeeping (refcounts, LRU, eviction of refcount-0
blocks only, release-to-cache, the max-blocks cap, cancel_lookup, double
release), run step for step on both; greedy token identity with the
reference's ServingEngine at prefix_cache=True and 8- or 16-token chunks
for MHA, GQA, int8 KV and int4 KV, with its scheduler counters;
copy-on-write; chunked against monolithic first tokens; the chunk
scatters and the context gather function by function (mid-block starts,
chunks that end past the prompt); chunks interleaving with decode; a
cache-hit suffix through the chunk program; admission with a tiny budget
thanks to cached blocks; a blocked lookup; a timeout in the middle of a
chunked prefill; a follow-up turn hitting the blocks decode wrote; and
`generate(prefix_cache=...)`.

Not here, because the port does not have them yet: GPT serving
(test_prefix_cache.py's `test_gpt` parity case; ROADMAP Queue 1 item
10), the D5 / D7 audits (`analysis.audit_decode_config`,
`audit_prefix_cache`; the "static analysis" entry after Queue 1) and
the metrics registry (`engine.metrics()`; item 7).
The end-to-end identity with the cache on runs in
test_torch_prefix_cache_identity{,_quant}.py (other workers).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import engine as jax_engine
from paddle_tpu.text import paged_cache as ref_cache
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM

from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.text import paged_cache as port_cache
from paddle_tpu_torch.text.models import LlamaConfig, llama_from_numpy

_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=128)

#: the scheduler counters both engines must agree on
_COUNTERS = ("steps", "decode_tokens", "prefill_tokens",
             "requests_completed", "admission_blocked", "kv_pool_free",
             "prefix_blocks_hit", "prefix_blocks_missed",
             "prefix_cached_blocks", "prefix_evictions", "prefill_chunks")


def _pair(kv_heads=None):
    """The same tiny LLaMA in both packages: paddle_tpu's random init,
    carried across as numpy."""
    kw = dict(_KW, num_key_value_heads=kv_heads)
    paddle.seed(0)
    ref = PLlamaForCausalLM(PLlamaConfig(**kw))
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    return ref, llama_from_numpy(LlamaConfig(**kw), state, device="cpu")


def _port(**kw):
    return _pair(**kw)[1]


def _engines(kv_heads=None, **kw):
    ref, port = _pair(kv_heads)
    return (jax_engine.ServingEngine(ref, max_slots=2, kv_block_size=8, **kw),
            ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu",
                          **kw))


def _drive(eng, prompts, gens, sequential):
    """The requests through one engine, one at a time to completion (so
    later requests hit what earlier ones registered) or all queued at
    once; returns the outputs in order."""
    rids = []
    for p, g in zip(prompts, gens):
        rids.append(eng.add_request(p, max_new_tokens=g))
        if sequential:
            eng.run()
    out = eng.run()
    return [out[r] for r in rids]


def _assert_same(a, b, prompts, gens, sequential=True):
    """Equal outputs and scheduler counters from the reference engine `a`
    and the port's `b`; returns the port's outputs."""
    want = _drive(a, prompts, gens, sequential)
    got = _drive(b, prompts, gens, sequential)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    sa, sb = a.stats(), b.stats()
    for key in _COUNTERS:
        assert sb[key] == sa[key], (key, sb[key], sa[key])
    assert b.prefix_cache.referenced_blocks == 0
    return got


def _shared_stream(seed=0, vocab=128):
    """Prompts sharing a 20-token prefix (2 full 8-token blocks), a
    prompt repeated whole, a block-aligned prompt repeated whole (the
    copy-on-write path) and a cold long one."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, (20,))
    prompts = [np.concatenate([shared, rs.randint(0, vocab, (k,))])
               for k in (3, 5, 2, 12)]
    aligned = rs.randint(0, vocab, (24,))
    prompts += [prompts[1].copy(), aligned, rs.randint(0, vocab, (40,)),
                aligned.copy()]
    return prompts, [5, 4, 6, 3, 5, 4, 3, 4]


# ------------------------------------------------------------ hash chain

class TestHashChain:
    def test_full_blocks_only(self):
        for n, want in ((15, 0), (16, 1), (33, 2)):
            assert len(port_cache.hash_blocks(np.arange(n), 16)) == want

    def test_chained_identity(self):
        a = port_cache.hash_blocks(np.r_[np.full(16, 1), np.full(16, 9)], 16)
        b = port_cache.hash_blocks(np.r_[np.full(16, 2), np.full(16, 9)], 16)
        assert a[0] != b[0] and a[1] != b[1]

    def test_namespace_partitions(self):
        t = np.arange(16)
        assert port_cache.hash_blocks(t, 16, namespace=1) \
            != port_cache.hash_blocks(t, 16, namespace=2)

    @pytest.mark.parametrize("n,bs,ns", [(40, 8, 0), (33, 16, 7),
                                         (64, 16, 2 ** 63 + 5)])
    def test_digests_equal_reference(self, n, bs, ns):
        toks = np.random.RandomState(n).randint(0, 32000, (n,))
        assert port_cache.hash_blocks(toks, bs, ns) \
            == ref_cache.hash_blocks(toks, bs, ns)


# ----------------------------------------------------------- PrefixCache
# Each scenario runs on the port's classes and the reference's; the
# returned traces (block ids, counters) must be equal, and the contract
# assertions hold on the port.

def _release_to_cache_then_hit(mod):
    pc = mod.PrefixCache(mod.BlockAllocator(8))
    h = mod.hash_blocks(np.arange(32), 16)
    ids = pc.allocate(2)
    pc.register(h, ids)
    pc.release(ids)
    parked = (pc.evictable, pc.cached_blocks)
    found = pc.lookup(h)
    return {"ids": ids, "parked": parked, "found": found, "hits": pc.hits,
            "evictable": pc.evictable}


def _unmapped_blocks_free_list(mod):
    alloc = mod.BlockAllocator(8)
    pc = mod.PrefixCache(alloc)
    pc.release(pc.allocate(3))
    return {"available": alloc.available, "cached": pc.cached_blocks}


def _eviction_is_lru_and_refcount0_only(mod):
    alloc = mod.BlockAllocator(6)          # 5 usable
    pc = mod.PrefixCache(alloc)
    held = pc.allocate(2)
    pc.register(mod.hash_blocks(np.arange(32), 16), held)     # refcount 1
    parked = pc.allocate(2)
    pc.register(mod.hash_blocks(np.arange(100, 132), 16), parked)
    pc.release(parked)                     # refcount 0 -> LRU
    got = pc.allocate(3)                   # 1 free + 2 evictable
    return {"got": got, "evictions": pc.evictions,
            "held_ref": pc.refcount(held[0]), "cached": pc.cached_blocks,
            "over_ask": pc.allocate(1)}


def _max_cached_blocks_cap(mod):
    pc = mod.PrefixCache(mod.BlockAllocator(10), max_cached_blocks=2)
    ids = pc.allocate(4)
    pc.register(mod.hash_blocks(np.arange(64), 16), ids)
    pc.release(ids)
    return {"evictable": pc.evictable, "evictions": pc.evictions,
            "lru": list(pc._lru)}


def _cancel_lookup_rolls_back(mod):
    pc = mod.PrefixCache(mod.BlockAllocator(8))
    h = mod.hash_blocks(np.arange(32), 16)
    ids = pc.allocate(2)
    pc.register(h, ids)
    pc.release(ids)
    found = pc.lookup(h + [b"x" * 32])
    pc.cancel_lookup(found, 3)
    return {"hits": pc.hits, "misses": pc.misses, "evictable": pc.evictable}


def _double_release_raises(mod):
    pc = mod.PrefixCache(mod.BlockAllocator(4))
    ids = pc.allocate(1)
    pc.release(ids)
    with pytest.raises(ValueError):
        pc.release(ids)
    return {"available": pc.available}


def _rekey_and_duplicate_register(mod):
    """register: a hash already mapped keeps its block; a block
    registered again under a new hash is rekeyed."""
    pc = mod.PrefixCache(mod.BlockAllocator(8))
    h1, h2 = mod.hash_blocks(np.arange(32), 16)
    a, b = pc.allocate(2)
    pc.register([h1], [a])
    pc.register([h1], [b])                  # h1 stays on a
    pc.register([h2], [a])                  # a rekeyed to h2
    return {"h1": pc.lookup([h1]), "h2": pc.lookup([h2]),
            "cached": pc.cached_blocks, "ref_a": pc.refcount(a)}


_SCENARIOS = [_release_to_cache_then_hit, _unmapped_blocks_free_list,
              _eviction_is_lru_and_refcount0_only, _max_cached_blocks_cap,
              _cancel_lookup_rolls_back, _double_release_raises,
              _rekey_and_duplicate_register]


@pytest.mark.parametrize("scenario", _SCENARIOS,
                         ids=[f.__name__.strip("_") for f in _SCENARIOS])
def test_prefix_cache_matches_reference(scenario):
    assert scenario(port_cache) == scenario(ref_cache)


def test_prefix_cache_contracts():
    t = _release_to_cache_then_hit(port_cache)
    assert t["parked"] == (2, 2) and t["found"] == t["ids"]
    assert t["hits"] == 2 and t["evictable"] == 0
    t = _unmapped_blocks_free_list(port_cache)
    assert t == {"available": 7, "cached": 0}
    t = _eviction_is_lru_and_refcount0_only(port_cache)
    assert t["got"] is not None and t["evictions"] == 2
    assert t["held_ref"] == 1 and t["cached"] == 2 and t["over_ask"] is None
    t = _max_cached_blocks_cap(port_cache)
    assert t["evictable"] == 2 and t["evictions"] == 2
    t = _cancel_lookup_rolls_back(port_cache)
    assert t == {"hits": 0, "misses": 0, "evictable": 2}


# --------------------------------------------- chunk scatters and gather

_CHUNKS = [(8, 12, 20), (8, 12, 17), (16, 3, 15), (16, 13, 30),
           (8, 0, 8), (8, 40, 43), (32, 5, 33)]
_CHUNK_IDS = [f"c{c}-start{s}-end{e}" for c, s, e in _CHUNKS]


def _chunk_case(c, seed, bs=8, nb=10, hkv=2, d=4):
    rs = np.random.RandomState(seed)
    ks = rs.randn(c, hkv, d).astype(np.float32)
    pool = rs.randn(nb, hkv, bs, d).astype(np.float32)
    q8 = rs.randint(-127, 128, (nb, hkv, bs, d)).astype(np.int8)
    q4 = rs.randint(-128, 128, (nb, hkv, bs // 2, d)).astype(np.int8)
    scale = ((rs.rand(nb) + 0.1) * 0.02).astype(np.float32)
    table = np.array([3, 5, 7, 2, 9, 0], np.int32)
    return ks, pool, q8, q4, scale, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,start,end", _CHUNKS, ids=_CHUNK_IDS)
def test_scatter_chunk_matches_reference(c, start, end, dtype):
    """Token-granular scatter, exact, in the pool's dtype (block 0, the
    trash block, takes the padded positions in any order)."""
    ks, pool, _, _, _, table = _chunk_case(c, c + start)
    want = np.asarray(ref_cache.scatter_chunk(
        jnp.asarray(pool, dtype), jnp.asarray(ks, dtype), start, end,
        jnp.asarray(table), 8).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = port_cache.scatter_chunk(
        torch.from_numpy(pool).to(tdt), torch.from_numpy(ks).to(tdt), start,
        end, torch.from_numpy(table), 8).float().numpy()
    np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("c,start,end", _CHUNKS, ids=_CHUNK_IDS)
def test_quantized_scatter_chunk_matches_reference(c, start, end, fmt):
    """The requantizing chunk scatters: codes exact, scales within rtol
    1e-6 (measured: equal), outside the trash block."""
    ks, _, q8, q4, scale, table = _chunk_case(c, c + start)
    codes = q8 if fmt == "int8" else q4
    ref_fn = getattr(ref_cache, f"scatter_chunk_{fmt}")
    port_fn = getattr(port_cache, f"scatter_chunk_{fmt}")
    wc, ws = ref_fn(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(ks),
                    start, end, jnp.asarray(table), 8)
    gc, gs = port_fn(torch.from_numpy(codes.copy()),
                     torch.from_numpy(scale.copy()), torch.from_numpy(ks),
                     start, end, torch.from_numpy(table), 8)
    np.testing.assert_array_equal(gc.numpy()[1:], np.asarray(wc)[1:])
    np.testing.assert_allclose(gs.numpy()[1:], np.asarray(ws)[1:],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("fmt", ["model", "int8", "int4"])
def test_gather_context_matches_reference(fmt):
    _, pool, q8, q4, scale, table = _chunk_case(8, 1)
    cache = {"model": pool, "int8": q8, "int4": q4}[fmt]
    sc = None if fmt == "model" else scale
    for pages in (1, 4, 6):
        want = np.asarray(ref_cache.gather_context(
            jnp.asarray(cache), None if sc is None else jnp.asarray(sc),
            jnp.asarray(table), pages, int4=fmt == "int4"))
        got = port_cache.gather_context(
            torch.from_numpy(cache), None if sc is None
            else torch.from_numpy(sc), torch.from_numpy(table), pages,
            int4=fmt == "int4").numpy()
        np.testing.assert_array_equal(got, want)


def test_int8_chunk_spanning_page_boundary():
    """A chunk shorter than a block that starts mid-block still spans two
    pages: every token of chunk [12, 20) at bs 16 gathers back within
    quantization error, as in the reference."""
    bs, nb, hkv, d = 16, 8, 2, 4
    ks = np.random.RandomState(7).randn(8, hkv, d).astype(np.float32)
    table = np.array([3, 5, 0, 0], np.int32)
    out = []
    for mod, arr in ((ref_cache, jnp.asarray), (port_cache, torch.tensor)):
        cache = arr(np.zeros((nb, hkv, bs, d), np.int8))
        scale = arr(np.full((nb,), 1e-8, np.float32))
        cache, scale = mod.scatter_chunk_int8(cache, scale, arr(ks), 12, 20,
                                              arr(table), bs)
        out.append(np.asarray(mod.gather_context(cache, scale, arr(table),
                                                 2))[12:20])
    np.testing.assert_allclose(out[1], ks, atol=0.05)
    np.testing.assert_array_equal(out[1], out[0])


# ------------------------------------------------- the engine, end to end

_MODES = [(None, None), (2, None), (None, "int8"), (None, "int4")]
_MODE_IDS = ["mha", "gqa", "int8kv", "int4kv"]


def identity_with_cache_on(kv_heads, kv_dtype, chunk):
    """Greedy tokens and scheduler counters equal the reference's at
    prefix_cache=True with 8- and 16-token chunks: prompts sharing a
    prefix one at a time, then all queued at once. Run for each mode by
    test_torch_prefix_cache_identity{,_quant}.py's
    `test_greedy_token_identity_with_cache_on`."""
    prompts, gens = _shared_stream()
    kw = dict(prefix_cache=True, chunked_prefill_tokens=chunk,
              kv_cache_dtype=kv_dtype)
    a, b = _engines(kv_heads, **kw)
    _assert_same(a, b, prompts, gens, sequential=True)
    assert b.stats()["prefix_blocks_hit"] >= 8
    assert b.stats()["prefill_chunks"] >= 4
    a, b = _engines(kv_heads, **kw)
    _assert_same(a, b, prompts, gens, sequential=False)


def test_cache_on_and_off_give_the_same_tokens():
    """The port alone: the cache changes no greedy token."""
    prompts, gens = _shared_stream(1)
    port = _port()
    on = _drive(ServingEngine(port, max_slots=2, kv_block_size=8,
                              prefix_cache=True, device="cpu"),
                prompts, gens, True)
    eng_off = ServingEngine(port, max_slots=2, kv_block_size=8,
                            prefix_cache=False, device="cpu")
    off = _drive(eng_off, prompts, gens, True)
    for x, y in zip(on, off):
        np.testing.assert_array_equal(x, y)
    assert eng_off.stats()["prefix_blocks_hit"] == 0


class TestCopyOnWrite:
    def test_whole_prompt_hit_cow_parity_and_source_intact(self):
        """A block-aligned prompt served three times: the second and third
        hit every full block and recompute the last token into a copy; the
        shared source block stays intact (the third still matches) and no
        ref leaks."""
        p = np.random.RandomState(3).randint(0, 128, (16,))
        a, b = _engines(prefix_cache=True)
        out = _assert_same(a, b, [p, p, p], [4, 4, 4])
        np.testing.assert_array_equal(out[1], out[0])
        np.testing.assert_array_equal(out[2], out[0])
        assert b.stats()["prefix_blocks_hit"] >= 4

    def test_cow_releases_source_ref(self):
        p = np.random.RandomState(4).randint(0, 128, (16,))
        eng = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                            prefix_cache=True, device="cpu")
        free0 = eng.prefix_cache.available
        rids = []
        for _ in range(2):
            rids.append(eng.add_request(p, max_new_tokens=3))
            eng.step()
            if len(rids) == 2:                 # the COW admission
                assert eng._slot_extra_refs[0] == []
                assert eng._slot_req[0].cached_len == 15
            eng.run()
        assert eng.prefix_cache.available == free0
        assert eng.prefix_cache.referenced_blocks == 0


class TestChunkedPrefill:
    def test_first_token_matches_monolithic(self):
        """Chunked prefill (4 chunks of 16) gives the monolithic path's
        tokens, and the reference's."""
        p = np.random.RandomState(5).randint(0, 128, (50,))
        outs = []
        for chunk in (16, 0):
            a, b = _engines(prefix_cache=False, chunked_prefill_tokens=chunk)
            outs.append(_assert_same(a, b, [p], [6])[0])
            assert b.stats()["prefill_chunks"] == (4 if chunk else 0)
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_chunks_interleave_with_decode(self):
        """A long prompt prefills one chunk per tick while another slot
        keeps decoding."""
        rs = np.random.RandomState(6)
        eng = ServingEngine(_port(), max_slots=2, kv_block_size=8,
                            prefix_cache=False, chunked_prefill_tokens=8,
                            device="cpu")
        short = eng.add_request(rs.randint(0, 128, (4,)), max_new_tokens=20)
        eng.step()
        long_r = eng.add_request(rs.randint(0, 128, (40,)), max_new_tokens=4)
        long_req = eng._waiting[0]
        decoded_during_prefill = 0
        for _ in range(50):
            before = len(eng._slot_req[0].tokens) \
                if eng._slot_req[0] is not None else None
            eng.step()
            if not long_req.prefill_done and before is not None:
                decoded_during_prefill += len(eng._slot_req[0].tokens) \
                    - before
            if long_req.prefill_done:
                break
        assert eng.stats()["prefill_chunks"] == 5          # ceil(40/8)
        assert decoded_during_prefill >= 3
        out = eng.run()
        assert len(out[long_r]) == 4 and len(out[short]) == 20

    def test_cache_hit_suffix_rides_chunk_program(self):
        """With chunking off, a cache hit's suffix still takes the chunk
        program, once."""
        rs = np.random.RandomState(7)
        shared = rs.randint(0, 128, (24,))
        p1 = np.concatenate([shared, rs.randint(0, 128, (4,))])
        p2 = np.concatenate([shared, rs.randint(0, 128, (6,))])
        a, b = _engines(prefix_cache=True, chunked_prefill_tokens=0)
        _assert_same(a, b, [p1, p2], [3, 3])
        st = b.stats()
        assert st["prefix_blocks_hit"] == 3 and st["prefill_chunks"] == 1


class TestAdmissionAccounting:
    def test_cached_request_admits_with_tiny_budget(self):
        """7 usable blocks; a cold 24 + 8 token request needs 4, so two run
        at once only when the second shares the first's whole prompt."""
        p = np.random.RandomState(8).randint(0, 128, (24,))

        def overlap(cache_on):
            eng = ServingEngine(_port(), max_slots=2, kv_block_size=8,
                                num_kv_blocks=8, prefix_cache=cache_on,
                                device="cpu")
            eng.add_request(p, max_new_tokens=8)
            eng.step()
            eng.add_request(p, max_new_tokens=8)
            both = False
            while eng.has_work():
                eng.step()
                both |= eng.num_active == 2
            return both

        assert overlap(True)
        assert not overlap(False)

    def test_blocked_lookup_does_not_leak(self):
        """A head-of-line request blocked on the pool leaks no refcount
        and inflates no hit counter across retries; counters equal the
        reference's."""
        rs = np.random.RandomState(9)
        p = rs.randint(0, 128, (16,))
        p2 = np.concatenate([p, rs.randint(0, 128, (8,))])
        a, b = _engines(prefix_cache=True, num_kv_blocks=7)
        for eng in (a, b):
            eng.add_request(p, max_new_tokens=20)        # 5 of 6 blocks
            eng.step()
            eng.add_request(p2, max_new_tokens=20)       # blocked
            for _ in range(5):
                eng.step()
            assert eng.num_waiting == 1
        assert b.prefix_cache.hits == a.prefix_cache.hits
        assert b.stats()["admission_blocked"] \
            == a.stats()["admission_blocked"] == 5
        want, got = a.run(), b.run()
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
        assert b.prefix_cache.referenced_blocks == 0
        for key in _COUNTERS:
            assert b.stats()[key] == a.stats()[key], key


def test_timeout_mid_chunk_prefill_releases_everything():
    rs = np.random.RandomState(10)
    eng = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                        prefix_cache=True, chunked_prefill_tokens=8,
                        device="cpu")
    free0 = eng.prefix_cache.available
    rid = eng.add_request(rs.randint(0, 128, (48,)), max_new_tokens=4,
                          max_time_ms=1.0)
    eng.step()                          # admit + first chunk
    assert not eng._slot_req[0].prefill_done
    time.sleep(0.003)
    eng.run()
    assert eng.finish_reasons[rid] == "timeout"
    assert eng.prefix_cache.available == free0
    assert eng.prefix_cache.referenced_blocks == 0


def test_timeout_before_cow_copy_releases_the_source():
    """A whole-prompt hit that times out before its first chunk ran
    releases the copy-on-write source's ref too."""
    p = np.random.RandomState(12).randint(0, 128, (16,))
    eng = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                        prefix_cache=True, device="cpu")
    free0 = eng.prefix_cache.available
    eng.add_request(p, max_new_tokens=3)
    eng.run()
    rid = eng.add_request(p, max_new_tokens=3, max_time_ms=1.0)
    list(eng._admit())                   # queued -> chunk ladder
    assert eng._slot_extra_refs[0]                   # the source, held
    time.sleep(0.003)
    eng.run()
    assert eng.finish_reasons[rid] == "timeout"
    assert eng.prefix_cache.available == free0
    assert eng.prefix_cache.referenced_blocks == 0


def test_prompt_plus_completion_hits_generated_blocks():
    """finish registers the full blocks of prompt + generation, so a
    follow-up turn hits blocks the decode wrote; tokens equal the
    reference's and the cache-off engine's."""
    p1 = np.random.RandomState(11).randint(0, 128, (10,))
    a, b = _engines(prefix_cache=True)
    first = _assert_same(a, b, [p1], [8])[0]
    turn2 = np.concatenate([p1, first[:6]])             # 2 blocks
    out = _assert_same(a, b, [turn2], [4])[0]
    assert b.stats()["prefix_blocks_hit"] == 2
    off = ServingEngine(_port(), max_slots=1, kv_block_size=8,
                        prefix_cache=False, device="cpu")
    np.testing.assert_array_equal(_drive(off, [turn2], [4], True)[0], out)


def test_generate_prefix_cache_kwarg():
    ref, port = _pair()
    prompt = np.random.RandomState(15).randint(0, 128, (2, 6))
    want = np.asarray(ref.generate(paddle.to_tensor(prompt),
                                   max_new_tokens=4, engine="paged",
                                   prefix_cache=True)._data)
    for flag in (True, False):
        got = port.generate(torch.from_numpy(prompt), max_new_tokens=4,
                            engine="paged", prefix_cache=flag)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="paged"):
        port.generate(torch.from_numpy(prompt), max_new_tokens=4,
                      prefix_cache=True)
