"""The serving engine's program table against paddle_tpu's program cache.

The reference compiles one XLA program per key (`ServingEngine._program`)
and records each key it meets in `_SEEN_SERVING_PROGRAMS`; the port keeps
a per-engine table of the same keys (`ServingEngine._programs`), which on
a card holds one captured CUDA graph per key and on the CPU calls the
same step functions on the same static buffers. Held here, on the same
seeded streams:

  (a) the set of program keys equals the reference's (read without its
      `_prog_key_base`, which fingerprints the model) for the streams of
      test_torch_serving.py and test_torch_prefix_cache.py: MHA, GQA, int8
      and int4 KV, greedy and mixed sampling, the prefix cache on and off;
  (b) after `finish_warmup()`, 20 steady ticks add no key;
  (c) the chunk step, with its scalars as 0-dim tensors, a start in the
      middle of a block and the copy-on-write both set and unset (trash
      onto trash), leaves the reference's pools (every block but the
      trash block) and emits its token;
  (d) the prefill and decode steps with the token pick inside: greedy rows
      give the reference's tokens, and seeded sampled rows repeat.

Whether the graphs themselves replay what the eager engine computes is a
card test (tests/test_torch_cuda_kernels.py, `-k graph_engine`).
The program-key cases past the fifth run in
test_torch_serving_programs_keys.py (another worker).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import engine as jax_engine
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM

from paddle_tpu_torch.inference import engine as port_engine
from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.ops.quantized import int4_pack
from paddle_tpu_torch.text.models import LlamaConfig, llama_from_numpy

_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)


def _pair(kv_heads=None, max_pos=128):
    """The same tiny LLaMA in both packages: paddle_tpu's random init,
    carried across as numpy."""
    kw = dict(_KW, num_key_value_heads=kv_heads,
              max_position_embeddings=max_pos)
    paddle.seed(0)
    ref = PLlamaForCausalLM(PLlamaConfig(**kw))
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    return ref, llama_from_numpy(LlamaConfig(**kw), state, device="cpu")


def _engines(kv_heads=None, max_pos=128, **kw):
    ref, port = _pair(kv_heads, max_pos)
    return (jax_engine.ServingEngine(ref, max_slots=2, kv_block_size=8, **kw),
            ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu",
                          **kw))


def _ref_keys(run):
    """The reference's program keys met while `run()` runs, as the port
    keys them: (site, bucket, any_sample, extra). The event mirror is
    cleared first, so that every key of the run records, and restored
    after (as tests/test_obs.py does with its mirror)."""
    seen = jax_engine._SEEN_SERVING_PROGRAMS
    saved = set(seen)
    seen.clear()
    try:
        run()
        return {(site, bucket, any_sample, tuple(extra))
                for site, _, any_sample, bucket, extra in seen}
    finally:
        seen.clear()
        seen.update(saved)


# ------------------------------------------------- (a) the program keys

#: test_torch_serving.py's stream: (prompt length, new tokens)
_STREAM = ((3, 4), (7, 6), (2, 9), (5, 3), (4, 5), (11, 4))
_OFF = dict(prefix_cache=False, chunked_prefill_tokens=0)


def _serving_stream(sampled=()):
    """`_STREAM`'s requests (seed 3), all queued at once; the requests
    numbered in `sampled` sample (temperature, top-k, top-p)."""
    rs = np.random.RandomState(3)
    reqs = []
    for i, (ln, nt) in enumerate(_STREAM):
        kw = dict(do_sample=True, temperature=0.8, top_k=20,
                  top_p=0.9) if i in sampled else {}
        reqs.append((rs.randint(0, 128, (ln,)), dict(max_new_tokens=nt,
                                                    **kw)))
    return reqs, False


def _shared_stream(sampled=(), sequential=True):
    """test_torch_prefix_cache.py's stream (seed 0): prompts sharing a
    20-token prefix, a whole-prompt repeat, a block-aligned prompt
    repeated whole (copy-on-write) and a cold 40-token prompt, one at a
    time to completion or all queued."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, 128, (20,))
    prompts = [np.concatenate([shared, rs.randint(0, 128, (k,))])
               for k in (3, 5, 2, 12)]
    aligned = rs.randint(0, 128, (24,))
    prompts += [prompts[1].copy(), aligned, rs.randint(0, 128, (40,)),
                aligned.copy()]
    gens = [5, 4, 6, 3, 5, 4, 3, 4]
    reqs = []
    for i, (p, g) in enumerate(zip(prompts, gens)):
        kw = dict(do_sample=True, temperature=1.2, top_k=30) \
            if i in sampled else {}
        reqs.append((p, dict(max_new_tokens=g, **kw)))
    return reqs, sequential


def _drive(eng, reqs, sequential):
    rids = []
    for p, kw in reqs:
        rids.append(eng.add_request(p, **kw))
        if sequential:
            eng.run()
    out = eng.run()
    return [out[r] for r in rids]


_KEY_CASES = {
    "mha-whole-prompt": (None, _OFF, _serving_stream),
    "gqa-defaults": (2, {}, _serving_stream),
    "gqa-chunk8": (2, dict(chunked_prefill_tokens=8), _serving_stream),
    "mixed-sampling": (None, dict(chunked_prefill_tokens=8),
                       lambda: _serving_stream(sampled=(1, 4))),
    "cache-on-mha-chunk8": (None, dict(chunked_prefill_tokens=8),
                            _shared_stream),
    "cache-on-gqa-chunk16-queued": (
        2, dict(chunked_prefill_tokens=16),
        lambda: _shared_stream(sequential=False)),
    "cache-on-int8kv": (None, dict(chunked_prefill_tokens=8,
                                   kv_cache_dtype="int8"), _shared_stream),
    "cache-on-int4kv-chunk16": (None, dict(chunked_prefill_tokens=16,
                                           kv_cache_dtype="int4"),
                                _shared_stream),
    "cache-on-sampling": (None, dict(chunked_prefill_tokens=8),
                          lambda: _shared_stream(sampled=(0, 5, 6))),
    "cache-off-chunk8": (None, dict(prefix_cache=False,
                                    chunked_prefill_tokens=8),
                         _shared_stream),
}


@pytest.mark.parametrize("case", list(_KEY_CASES)[:5])
def test_program_keys_match_reference(case):
    """The port's table holds exactly the reference's program keys on the
    same stream, and the greedy requests' tokens are the reference's."""
    kv_heads, kw, stream = _KEY_CASES[case]
    reqs, sequential = stream()
    a, b = _engines(kv_heads, **kw)
    out = {}
    want = _ref_keys(lambda: out.setdefault("ref",
                                            _drive(a, reqs, sequential)))
    got = _drive(b, reqs, sequential)
    assert set(b._programs) == want
    assert all(isinstance(k[1], int) and isinstance(k[2], bool)
               for k in want)
    sites = {k[0] for k in want}
    assert sites <= {"serving.decode", "serving.prefill",
                     "serving.chunk_prefill"}
    for (_, kw_r), x, y in zip(reqs, out["ref"], got):
        assert len(x) == len(y)
        if not kw_r.get("do_sample"):
            np.testing.assert_array_equal(y, x)
    assert b._captures == [0, 0]          # the CPU captures nothing


def test_key_sites_and_extras():
    """A stream that reaches every site: whole-prompt prefill, a chunk
    ladder (non-final chunks key is_last False and no sampling), a
    sampling final chunk and sampling decode."""
    a, b = _engines(chunked_prefill_tokens=8)
    reqs = [(np.arange(5) % 128, dict(max_new_tokens=3)),
            (np.arange(20) % 128, dict(max_new_tokens=3, do_sample=True))]
    want = _ref_keys(lambda: _drive(a, reqs, True))
    _drive(b, reqs, True)
    assert set(b._programs) == want
    chunks = sorted(k for k in want if k[0] == "serving.chunk_prefill")
    assert [k[3][1] for k in chunks].count(True) >= 1
    assert all(k[2] == k[3][1] for k in chunks)   # sampling only when last
    assert ("serving.decode", 1, True, ()) in want
    assert any(k[0] == "serving.prefill" and not k[2] for k in want)


# ------------------------------------------------ (b) no key after warmup

@pytest.mark.parametrize("kw", [_OFF, dict(chunked_prefill_tokens=8)],
                         ids=["whole-prompt", "chunk8"])
def test_no_new_program_after_warmup(kw):
    """Warm every bucket of the workload (prompt bucket 16, decode buckets
    1 and 2), finish_warmup(), then 20 steady ticks add no key, as
    tests/test_obs.py holds the reference to zero compiles."""
    eng = ServingEngine(_pair(max_pos=64)[1], max_slots=2, kv_block_size=8,
                        device="cpu", **kw)
    rs = np.random.RandomState(0)
    for ln, nt in ((3, 2), (6, 3)):
        eng.add_request(rs.randint(0, 128, (ln,)), max_new_tokens=nt)
    eng.run()
    eng.finish_warmup()
    keys = set(eng._programs)
    for ln, nt in ((4, 25), (5, 22)):
        eng.add_request(rs.randint(0, 128, (ln,)), max_new_tokens=nt)
    steps = 0
    while eng.has_work() and steps < 30:
        eng.step()
        steps += 1
    assert steps >= 20
    assert set(eng._programs) == keys
    assert eng._graph_stats()["captures_after_warmup"] == 0


# --------------------------------------------------- (c) the chunk step

def _pools(mode, rs, b, layers=2, bs=8):
    """Seeded contents (numpy) for the pool of the port's engine `b`: f32
    K/V, or int8 codes (int4: packed codes in -7..7) with positive
    per-(layer, block) scales."""
    blocks = b.cache.num_blocks
    shape = (layers, blocks, b.spec.num_kv_heads, bs, b.spec.head_dim)
    if mode == "model":
        return [rs.randn(*shape).astype(np.float32) for _ in range(2)], None
    if mode == "int8":
        codes = [rs.randint(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
    else:
        codes = [int4_pack(torch.from_numpy(rs.randint(-7, 8, shape)
                                            .astype(np.int8)),
                           axis=-2).numpy() for _ in range(2)]
    scales = [rs.uniform(0.01, 0.05, (layers, blocks)).astype(np.float32)
              for _ in range(2)]
    return codes, scales


def _port_pool(b, codes, scales):
    b.cache.k.copy_(torch.from_numpy(codes[0]))
    b.cache.v.copy_(torch.from_numpy(codes[1]))
    if scales is not None:
        b.cache.k_scale.copy_(torch.from_numpy(scales[0]))
        b.cache.v_scale.copy_(torch.from_numpy(scales[1]))


def _assert_pools(b, ref_out, mode, written):
    """The port's pool equals the reference's outside the trash block:
    int8 / int4 codes exactly, scales within rtol 1e-6, f32 values
    exactly wherever the step computed nothing (untouched blocks, the
    copy-on-write's copy). The f32 K/V the step computed (`written`:
    {block: offsets}) come from the two frameworks' matmuls, whose sums
    round in other orders: within 4e-6 (a few ulps of the O(1) entries;
    1e-6 apart at most in these cases)."""
    _, ck, cv, cks, cvs, _ = ref_out
    for got, want in ((b.cache.k, ck), (b.cache.v, cv)):
        got, want = got.numpy().copy(), np.asarray(want).copy()
        if mode == "model":
            for blk, offs in written.items():
                sl = (slice(None), blk, slice(None), offs)
                np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                                           atol=4e-6)
                got[sl] = want[sl] = 0
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    if mode != "model":
        for got, want in ((b.cache.k_scale, cks), (b.cache.v_scale, cvs)):
            np.testing.assert_allclose(got.numpy()[:, 1:],
                                       np.asarray(want)[:, 1:], rtol=1e-6)


def _written(table, start, end, bs=8):
    """{block: [offsets]} of the token slots positions [start, end) land
    on through `table`."""
    out = {}
    for p in range(start, end):
        out.setdefault(int(table[p // bs]), []).append(p % bs)
    return out


_CHUNK_CASES = [  # (chunk bucket, start, true_end, is_last, cow)
    (8, 13, 21, True, None),             # starts mid-block, final chunk
    (8, 13, 21, False, None),            # the same, not final
    (16, 7, 20, True, (3, 5)),           # block 3 copied into page 0's
    (8, 0, 8, False, (0, 0)),            # trash onto trash, page-aligned
]


@pytest.mark.parametrize("mode", ["model", "int8", "int4"])
@pytest.mark.parametrize("c,start,end,is_last,cow", _CHUNK_CASES,
                         ids=["mid-block-last", "mid-block", "cow",
                              "no-cow"])
def test_chunk_step_with_tensor_scalars_matches_reference(mode, c, start,
                                                          end, is_last, cow):
    rs = np.random.RandomState(c + start + end)
    a, b = _engines(kv_cache_dtype=None if mode == "model" else mode)
    codes, scales = _pools(mode, rs, b)
    table = np.zeros(b.pages, np.int32)
    table[:4] = [5, 2, 7, 9]
    ids = np.zeros((1, c), np.int64)
    ids[0, :end - start] = rs.randint(0, 128, (end - start,))
    cow_src, cow_dst = cow or (0, 0)
    ctx_pages = 4
    ref = jax_engine._chunk_prefill_step(
        a.spec, 8, a.kv_mode, False, is_last, ctx_pages, a.params,
        jnp.asarray(ids, jnp.int32), jnp.int32(start), jnp.int32(end),
        jnp.int32(end - 1 - start), jnp.asarray(table), jnp.int32(cow_src),
        jnp.int32(cow_dst), jnp.asarray(codes[0]), jnp.asarray(codes[1]),
        None if scales is None else jnp.asarray(scales[0]),
        None if scales is None else jnp.asarray(scales[1]),
        a._samp_arrays([]), jax.random.PRNGKey(0))
    _port_pool(b, codes, scales)
    scalars = [torch.tensor(v) for v in (start, end, end - 1 - start,
                                         cow_src, cow_dst)]
    tok = port_engine._chunk_prefill_step(
        b.spec, 8, b.kv_mode, is_last, ctx_pages, b.params, b.cache,
        torch.from_numpy(ids), *scalars[:3], torch.from_numpy(table),
        *scalars[3:], sample=(False, {}, None))
    _assert_pools(b, ref, mode, _written(table, start, end))
    if is_last:
        assert tok.tolist() == np.asarray(ref[0]).tolist()
    else:
        assert tok is None


# -------------------------------------- (d) prefill and decode, picks in

def _samp(rows):
    """Host sampling arrays for `rows` of (do_sample, temperature, top_k,
    top_p), as the port's engine makes them."""
    return {"do_sample": np.array([r[0] for r in rows]),
            "temperature": np.array([r[1] for r in rows], np.float32),
            "top_k": np.array([r[2] for r in rows], np.int32),
            "top_p": np.array([r[3] for r in rows], np.float32)}


@pytest.mark.parametrize("mode", ["model", "int8"])
def test_prefill_step_picks_the_reference_token(mode):
    rs = np.random.RandomState(11)
    a, b = _engines(kv_cache_dtype=None if mode == "model" else mode)
    codes, scales = _pools(mode, rs, b)
    table = np.zeros(b.pages, np.int32)
    table[:2] = [4, 8]
    ids = np.zeros((1, 16), np.int64)
    ids[0, :11] = rs.randint(0, 128, (11,))
    ref = jax_engine._prefill_step(
        a.spec, 8, a.kv_mode, False, a.params, jnp.asarray(ids, jnp.int32),
        jnp.int32(11), jnp.asarray(table), jnp.asarray(codes[0]),
        jnp.asarray(codes[1]),
        None if scales is None else jnp.asarray(scales[0]),
        None if scales is None else jnp.asarray(scales[1]),
        a._samp_arrays([]), jax.random.PRNGKey(0))
    _port_pool(b, codes, scales)
    tok = port_engine._prefill_step(
        b.spec, 8, b.kv_mode, b.params, b.cache, torch.from_numpy(ids),
        torch.tensor(11), torch.from_numpy(table), (False, {}, None))
    assert tok.tolist() == np.asarray(ref[0]).tolist()
    # the scatter is page-granular: both pages whole, padding included
    _assert_pools(b, ref, mode, _written(table, 0, 16))
    # a sampling key with a greedy row: the same argmax
    _port_pool(b, codes, scales)
    gen = torch.Generator().manual_seed(1)
    samp = {k: torch.from_numpy(v)
            for k, v in _samp([(False, 0.7, 5, 0.9)]).items()}
    tok = port_engine._prefill_step(
        b.spec, 8, b.kv_mode, b.params, b.cache, torch.from_numpy(ids),
        torch.tensor(11), torch.from_numpy(table), (True, samp, gen))
    assert tok.tolist() == np.asarray(ref[0]).tolist()


@pytest.mark.parametrize("mode", ["model", "int4"])
def test_decode_step_keeps_greedy_rows_and_repeats_sampled(mode):
    """Four rows, two greedy and two sampled, through one decode step
    with the pick inside: the greedy rows are the reference's argmax (its
    own sampling key), and a second run from the same pools and seed
    draws the same sampled tokens."""
    rs = np.random.RandomState(12)
    a, b = _engines(kv_cache_dtype=None if mode == "model" else mode)
    codes, scales = _pools(mode, rs, b)
    tables = np.zeros((4, b.pages), np.int32)
    tables[:, :2] = [[1, 2], [3, 4], [5, 6], [7, 8]]
    pos = np.array([9, 3, 15, 12], np.int64)
    tok = rs.randint(0, 128, (4,)).astype(np.int64)
    rows = [(False, 1.0, 0, 1.0), (True, 1.3, 20, 0.95),
            (False, 0.5, 3, 0.5), (True, 0.9, 0, 1.0)]
    samp = _samp(rows)
    ref = jax_engine._decode_step(
        a.spec, 8, a.kv_mode, True, a.params, jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(tables),
        jnp.asarray(codes[0]), jnp.asarray(codes[1]),
        None if scales is None else jnp.asarray(scales[0]),
        None if scales is None else jnp.asarray(scales[1]),
        {k: jnp.asarray(v) for k, v in samp.items()},
        jax.random.PRNGKey(0))
    want = np.asarray(ref[0])
    runs = []
    for _ in range(2):
        _port_pool(b, codes, scales)
        gen = torch.Generator().manual_seed(7)
        got = port_engine._decode_step(
            b.spec, 8, b.kv_mode, b.params, b.cache, torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(tables),
            (True, {k: torch.from_numpy(v) for k, v in samp.items()}, gen))
        runs.append(got.tolist())
    assert runs[0] == runs[1]
    assert [runs[0][i] for i in (0, 2)] == [int(want[i]) for i in (0, 2)]
    assert all(0 <= t < 128 for t in runs[0])
    greedy = port_engine._decode_step(
        b.spec, 8, b.kv_mode, b.params, b.cache, torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(tables), (False, {}, None))
    assert [greedy.tolist()[i] for i in (0, 2)] == [int(want[i])
                                                   for i in (0, 2)]


def test_engine_sampling_is_seeded_through_the_programs():
    """A mixed stream through two engines with one seed gives the same
    tokens, a third with another seed other sampled tokens; greedy
    requests keep the greedy engine's tokens."""
    port = _pair()[1]
    outs = []
    reqs, _ = _serving_stream(sampled=(0, 2, 5))
    for seed in (5, 5, 6):
        eng = ServingEngine(port, max_slots=2, kv_block_size=8,
                            device="cpu", seed=seed)
        outs.append(_drive(eng, reqs, False))
    for x, y in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(outs[0][i], outs[2][i]) for i in (0, 2, 5))
    greedy = _drive(ServingEngine(port, max_slots=2, kv_block_size=8,
                                  device="cpu"),
                    [(p, {"max_new_tokens": kw["max_new_tokens"]})
                     for p, kw in reqs], False)
    for i in (1, 3, 4):
        np.testing.assert_array_equal(outs[0][i], greedy[i])
