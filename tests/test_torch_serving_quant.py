"""The port's quantized serving against paddle_tpu's (the reference).

(d) The int8/int4 KV-cache updates (`append_token_int8/int4`,
`scatter_prefill_int8/int4`) write the same codes and scales as the
reference's from the same inputs. (e) Greedy tokens of the port's
`ServingEngine` equal those of paddle_tpu's engine (prefix cache off,
whole-prompt prefill) for every non-trivial (weight_quant,
kv_cache_dtype) pair on a tiny MHA LLaMA and for (int4, int4) and
(int8, int8) on a tiny GQA one, with the same `param_bytes` and
`kv_hbm_bytes`. (f) paddle_tpu's quantized serving params, carried across
with `serving_params_from_numpy`, equal the port's own extraction.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax.numpy as jnp
from paddle_tpu.inference import engine as jax_engine
from paddle_tpu.text import paged_cache as jax_cache
from paddle_tpu.text.generation import _stacked_params
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM

from paddle_tpu_torch.inference.engine import ServingEngine, generate_paged
from paddle_tpu_torch.text import paged_cache as port_cache
from paddle_tpu_torch.text.generation import _extract_llama
from paddle_tpu_torch.text.models import (LlamaConfig, llama_from_numpy,
                                          serving_params_from_numpy)

_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
_STREAM = ((3, 4), (7, 6), (2, 9), (5, 3), (4, 5), (11, 4))


def _pair(kv_heads=None):
    """The same tiny LLaMA in both packages: paddle_tpu's random init,
    carried across as numpy."""
    kw = dict(_KW, num_key_value_heads=kv_heads)
    paddle.seed(0)
    ref = PLlamaForCausalLM(PLlamaConfig(**kw))
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    return ref, llama_from_numpy(LlamaConfig(**kw), state, device="cpu")


# ------------------------------------------------ (d) cache update rules

def _pool(fmt, rs, layers=2, blocks=9, hkv=2, bs=8, d=4):
    rows = bs // 2 if fmt == "int4" else bs
    lo = -128 if fmt == "int4" else -127
    cache = rs.randint(lo, 128, (layers, blocks, hkv, rows, d)).astype(
        np.int8)
    scale = (rs.rand(layers, blocks) * 0.1 + 0.01).astype("float32")
    return cache, scale


def _port_args(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_scatter_prefill_quant_matches_reference(fmt):
    rs = np.random.RandomState(2)
    cache, scale = _pool(fmt, rs)
    ks = rs.randn(2, 16, 2, 4).astype("float32")          # [L, S, Hkv, D]
    row = np.array([3, 5, 7, 0], "int32")
    ref_fn = getattr(jax_cache, f"scatter_prefill_{fmt}")
    port_fn = getattr(port_cache, f"scatter_prefill_{fmt}")
    for true_len in (11, 16, 1):
        wc, ws = ref_fn(jnp.asarray(cache), jnp.asarray(scale),
                        jnp.asarray(ks), true_len, jnp.asarray(row), 8)
        tc, ts, tk, tr = _port_args(cache, scale, ks, row)
        gc, gs = port_fn(tc, ts, tk, true_len, tr, 8)
        assert gc is tc and gs is ts                          # in place
        # block 0 is the trash block: masked pages land there in any order
        np.testing.assert_array_equal(gc.numpy()[:, 1:],
                                      np.asarray(wc)[:, 1:])
        np.testing.assert_array_equal(gs.numpy()[:, 1:],
                                      np.asarray(ws)[:, 1:])


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_append_token_quant_matches_reference(fmt):
    rs = np.random.RandomState(3)
    cache, scale = _pool(fmt, rs)
    cache, scale = cache[0], scale[0]                 # one layer's slice
    ref_fn = getattr(jax_cache, f"append_token_{fmt}")
    port_fn = getattr(port_cache, f"append_token_{fmt}")
    blk = np.array([4, 6, 0, 2], "int32")
    for step, off in enumerate(([0, 7, 0, 3], [1, 3, 5, 7], [7, 0, 1, 4])):
        kv = rs.randn(4, 2, 4).astype("float32") * (step + 1)
        off = np.asarray(off, "int32")
        wc, ws = ref_fn(jnp.asarray(cache), jnp.asarray(scale),
                        jnp.asarray(kv), jnp.asarray(blk), jnp.asarray(off))
        tc, ts, tkv, tb, to = _port_args(cache, scale, kv, blk, off)
        gc, gs = port_fn(tc, ts, tkv, tb, to)
        assert gc is tc and gs is ts                          # in place
        np.testing.assert_array_equal(gc.numpy()[1:], np.asarray(wc)[1:])
        np.testing.assert_array_equal(gs.numpy()[1:], np.asarray(ws)[1:])
        cache, scale = np.asarray(wc), np.asarray(ws)     # chain the steps


@pytest.mark.parametrize("mode,rows", [("model", 8), ("int8", 8),
                                       ("int4", 4)])
def test_cache_modes_and_hbm_bytes_match_reference(mode, rows):
    want = jax_cache.PagedKVCache(2, 5, 2, 8, 16,
                                  mode if mode != "model" else jnp.float32)
    got = port_cache.PagedKVCache(2, 5, 2, 8, 16,
                                  mode if mode != "model" else torch.float32,
                                  "cpu")
    assert got.mode == want.mode and got.quantized == want.quantized
    assert got.stored_block_size == want.stored_block_size == rows
    assert tuple(got.k.shape) == tuple(want.k.shape)
    assert got.hbm_bytes == want.hbm_bytes
    if got.quantized:
        assert got.k.dtype == torch.int8
        np.testing.assert_array_equal(got.k_scale.numpy(),
                                      np.asarray(want.k_scale))


# ----------------------------------------------------- (e) serving parity

_COMBOS = [(w, kv) for w in ("none", "int8", "int4")
           for kv in ("model", "int8", "int4") if (w, kv) != ("none", "model")]


@pytest.mark.parametrize(
    "kv_heads,weight_quant,kv_cache_dtype",
    [(None, w, kv) for w, kv in _COMBOS]
    + [(2, "int4", "int4"), (2, "int8", "int8")],
    ids=lambda v: {None: "mha", 2: "gqa"}.get(v, v))
def test_greedy_token_identity_with_reference_engine(kv_heads, weight_quant,
                                                     kv_cache_dtype):
    ref, port = _pair(kv_heads=kv_heads)
    kw = dict(max_slots=2, kv_block_size=8, weight_quant=weight_quant,
              kv_cache_dtype=kv_cache_dtype)
    a = jax_engine.ServingEngine(ref, prefix_cache=False,
                                 chunked_prefill_tokens=0, **kw)
    b = ServingEngine(port, device="cpu", **kw)
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
                "requests_completed", "kv_pool_blocks", "kv_pool_free",
                "kv_hbm_bytes", "kv_cache_mode", "weight_quant",
                "param_bytes"):
        assert sb[key] == sa[key], key


def test_generate_paths_carry_the_quant_options():
    ref, port = _pair()
    prompt = np.random.RandomState(0).randint(0, 128, (2, 5))
    want = jax_engine.generate_paged(ref, prompt, 6, prefix_cache=False,
                                     weight_quant="int4",
                                     kv_cache_dtype="int8")
    got = generate_paged(port, prompt, 6, device="cpu", weight_quant="int4",
                         kv_cache_dtype="int8")
    np.testing.assert_array_equal(got, want)
    full = port.generate(torch.from_numpy(prompt), max_new_tokens=6,
                         engine="paged", weight_quant="int8")
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(ref.generate(
            paddle.to_tensor(prompt), max_new_tokens=6, engine="paged",
            prefix_cache=False, weight_quant="int8")._data))
    with pytest.raises(ValueError, match="weight_quant"):
        port.generate(torch.from_numpy(prompt), max_new_tokens=2,
                      engine="paged", weight_quant="int2")


def test_engine_flag_defaults_and_bad_modes():
    port = _pair()[1]
    eng = ServingEngine(port, max_slots=1, device="cpu")
    assert eng.weight_quant == "none" and eng.kv_mode == "model"
    assert eng.stats()["kv_cache_mode"] == "model"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingEngine(port, max_slots=1, kv_cache_dtype="fp8", device="cpu")


# ------------------------------------------- (f) weights carried across

def _assert_same(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("weight_quant", ["none", "int8", "int4"])
def test_converted_reference_params_equal_port_extraction(weight_quant):
    ref, port = _pair(kv_heads=2)
    stacked = jax.tree_util.tree_map(np.asarray,
                                     _stacked_params(ref, weight_quant))
    want = serving_params_from_numpy(stacked, device="cpu")
    got = _extract_llama(port, weight_quant)
    _assert_same(got, want)
    if weight_quant != "none":
        q, s = got["layers"][0]["gate"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert q.shape[0] == (32 if weight_quant == "int8" else 16)
        assert isinstance(got["layers"][0]["input_ln"], torch.Tensor)


def test_converted_params_keep_bf16_bits():
    """A bf16 model's serving params travel bit for bit (numpy holds them
    as ml_dtypes bfloat16, which torch cannot take directly)."""
    rs = np.random.RandomState(5)
    dense = jnp.asarray(rs.randn(2, 8, 4), jnp.bfloat16)        # [L, K, N]
    packed = rs.randint(-128, 128, (2, 4, 4)).astype(np.int8)
    scale = rs.rand(2, 4).astype("float32")
    params = {"embed": np.asarray(dense[0]), "final_ln": np.ones(4, "f4"),
              "layers": {"q": np.asarray(dense), "up": (packed, scale)}}
    got = serving_params_from_numpy(params, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert len(got["layers"]) == 2
    for i in range(2):
        lw = got["layers"][i]
        np.testing.assert_array_equal(lw["q"].float().numpy(),
                                      np.asarray(dense[i], np.float32))
        np.testing.assert_array_equal(lw["up"][0].numpy(), packed[i])
        np.testing.assert_array_equal(lw["up"][1].numpy(), scale[i])
