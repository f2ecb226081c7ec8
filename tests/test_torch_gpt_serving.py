"""GPT serving in the port held to paddle_tpu on the CPU: the block math
and the greedy paths.

Tiny GPT (vocab 96, hidden 32, 2 layers, 4 heads, 64 positions, f32),
paddle_tpu's seeded init carried across by `gpt_from_numpy`. The block
(`_attend_block` + `_mlp_block` at the spec's "gpt" arch), the logits
and the extracted params against the reference's `_gpt_layer_prefill`,
`_gpt_layer_decode`, `_logits` and `_stacked_params_gpt` (rtol 1e-5);
greedy token identity with the reference through the static `generate`,
`engine="paged"` and the serving engine on a mixed stream (prefix cache
off with whole prompts, and at the defaults), with `stats()` equal;
seeded sampling that repeats itself; requests that end exactly at
max_model_len, where chunk and verify positions run past the position
table and are clamped as the reference's gathers clamp them.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import jax.numpy as jnp
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
#: the prefix cache off and whole-prompt prefill, passed to both engines
_OFF = dict(prefix_cache=False, chunked_prefill_tokens=0)
_STREAM = ((3, 4), (7, 6), (2, 9), (5, 3), (11, 4))


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


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_spec_and_extracted_params_equal_reference():
    ref, port = _pair()
    rspec = ref_engine.ServingEngine(ref, max_slots=1).spec
    spec = generation._spec_for(port)
    for f in ("num_layers", "num_heads", "num_kv_heads", "head_dim",
              "rms_eps", "tie_embeddings", "arch"):
        assert getattr(spec, f) == getattr(rspec, f), f
    rp = ref_gen._stacked_params_gpt(ref)
    pp = generation._extract_gpt(port)
    for k in ("embed", "wpe", "final_ln", "final_ln_b", "lm_head"):
        np.testing.assert_array_equal(_np(pp[k]), np.asarray(rp[k]))
    assert len(pp["layers"]) == 2
    for i, lw in enumerate(pp["layers"]):
        assert set(lw) == set(rp["layers"])
        for k, w in lw.items():
            np.testing.assert_array_equal(_np(w), np.asarray(
                rp["layers"][k][i]))
    # the params are the model's own tensors, no copy
    assert pp["layers"][0]["qkv"].data_ptr() \
        == port.blocks[0].attn.qkv_proj.weight._data.data_ptr()


def test_block_and_logits_match_reference():
    """Prefill block (with its k/v), a seq-1 decode block against a dense
    cache, the layer norm and the logits, from the same inputs."""
    ref, port = _pair()
    rspec = ref_engine.ServingEngine(ref, max_slots=1).spec
    spec = generation._spec_for(port)
    rp = ref_gen._stacked_params_gpt(ref)
    pp = generation._extract_gpt(port)
    rs = np.random.RandomState(0)
    for li in range(2):
        rl = {k: v[li] for k, v in rp["layers"].items()}
        lw = pp["layers"][li]
        x = rs.randn(2, 7, 32).astype(np.float32)
        want, (wk, wv) = ref_gen._gpt_layer_prefill(jnp.asarray(x), rl,
                                                    rspec)
        got, (gk, gv) = generation._layer_forward_prefill(
            torch.from_numpy(x), lw, spec, None, None)
        _close(got, want)
        _close(gk, wk)
        _close(gv, wv)
        # decode: write at pos, attend over arange(T) <= pos
        t, pos = 12, 9
        xd = rs.randn(2, 32).astype(np.float32)
        kc = rs.randn(2, t, 4, 8).astype(np.float32)
        vc = rs.randn(2, t, 4, 8).astype(np.float32)
        want, wkc, wvc = ref_gen._gpt_layer_decode(
            jnp.asarray(xd), rl, jnp.asarray(kc), jnp.asarray(vc),
            jnp.int32(pos), rspec)
        pk, pv = torch.from_numpy(kc), torch.from_numpy(vc)
        valid = (torch.arange(t) <= pos)[None, None]

        def attend(q, k, v, pk=pk, pv=pv, valid=valid):
            pk[:, pos], pv[:, pos] = k, v
            return generation._dense_attention(q[:, None], pk, pv,
                                               valid)[:, 0]

        got = generation._cached_block(torch.from_numpy(xd), lw, spec,
                                       None, None, attend)
        _close(got, want)
        _close(pk, wkc)
        _close(pv, wvc)
    x = rs.randn(3, 32).astype(np.float32)
    _close(generation._layer_norm(torch.from_numpy(x), pp["final_ln"],
                                  pp["final_ln_b"], spec.rms_eps),
           ref_gen._layer_norm(jnp.asarray(x), rp["final_ln"],
                               rp["final_ln_b"], rspec.rms_eps))
    _close(generation._logits(torch.from_numpy(x), pp, spec),
           ref_gen._logits(jnp.asarray(x), rp, rspec))


def test_embed_adds_clamped_learned_positions():
    _, port = _pair()
    pp = generation._extract_gpt(port)
    spec = generation._spec_for(port)
    ids = torch.tensor([[1, 2, 3]])
    got = generation._embed(pp, spec, ids)
    want = pp["embed"][ids] + pp["wpe"][:3][None]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    far = generation._embed(pp, spec, ids[0], torch.tensor([62, 63, 70]))
    torch.testing.assert_close(far[2], pp["embed"][3] + pp["wpe"][63],
                               rtol=0, atol=0)
    assert generation._rope_at(pp, spec, torch.tensor([1])) == (None, None)


@pytest.mark.parametrize("b,s,seed", [(2, 5, 1), (2, 11, 2)])
def test_greedy_static_and_paged_identity(b, s, seed):
    """Prompt buckets 8 and 16, generation bucket 8: the static engine and
    engine="paged" both equal the reference's static generate."""
    ref, port = _pair()
    prompt = np.random.RandomState(seed).randint(0, 96, (b, s))
    want = np.asarray(ref.generate(paddle.to_tensor(prompt),
                                   max_new_tokens=7)._data)
    got = port.generate(torch.from_numpy(prompt), max_new_tokens=7)
    np.testing.assert_array_equal(got.numpy(), want)
    paged = port.generate(torch.from_numpy(prompt), max_new_tokens=7,
                          engine="paged")
    np.testing.assert_array_equal(paged.numpy(), want)


@pytest.mark.parametrize("kw", [_OFF, {}], ids=["whole-prompt", "defaults"])
def test_engine_token_identity_and_stats(kw):
    ref, port = _pair()
    a = ref_engine.ServingEngine(ref, max_slots=2, kv_block_size=8, **kw)
    b = ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu", **kw)
    rs = np.random.RandomState(3)
    for ln, nt in _STREAM:
        p = rs.randint(0, 96, (ln,))
        assert a.add_request(p, max_new_tokens=nt) \
            == b.add_request(p, max_new_tokens=nt)
    want, got = a.run(), b.run()
    assert sorted(want) == sorted(got) == list(range(len(_STREAM)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    sa, sb = a.stats(), b.stats()
    assert set(sa) == set(sb)
    for key, v in sa.items():
        if key.endswith("_s") or key == "param_bytes":
            continue
        assert sb[key] == v, key
    assert sb["param_bytes"] == sum(
        np.asarray(w).nbytes for w in jax.tree_util.tree_leaves(a.params))


def test_sampled_generate_repeats_with_its_seed():
    """Sampled tokens cannot reproduce JAX's random bits; with one seed
    they repeat, through the static engine and the paged one, and stay
    inside the top-k filter of the greedy path's logits."""
    _, port = _pair()
    prompt = torch.from_numpy(np.random.RandomState(4).randint(0, 96,
                                                               (2, 6)))
    for engine in ("static", "paged"):
        kw = dict(max_new_tokens=8, do_sample=True, top_k=4,
                  temperature=0.8, seed=11, engine=engine)
        first = port.generate(prompt, **kw)
        np.testing.assert_array_equal(first.numpy(),
                                      port.generate(prompt, **kw).numpy())
        assert first.shape == (2, 14)
        assert ((first >= 0) & (first < 96)).all()
    # top_k=1 sampling is the greedy path
    greedy = port.generate(prompt, max_new_tokens=8)
    np.testing.assert_array_equal(
        port.generate(prompt, max_new_tokens=8, do_sample=True, top_k=1,
                      seed=3).numpy(), greedy.numpy())


def test_requests_end_exactly_at_max_model_len():
    """Prompt + new tokens = 64 = max_model_len: a 12-token chunk ladder
    whose last chunk bucket reaches positions 60..67, past the 64-row wpe
    table (clamped), and a whole prompt of 60 with 4 new tokens."""
    ref, port = _pair()
    rs = np.random.RandomState(5)
    prompts = [(rs.randint(0, 96, (63,)), 1), (rs.randint(0, 96, (60,)), 4)]
    kw = dict(max_slots=2, kv_block_size=8, chunked_prefill_tokens=12)
    a = ref_engine.ServingEngine(ref, **kw)
    b = ServingEngine(port, device="cpu", **kw)
    for p, n in prompts:
        a.add_request(p, max_new_tokens=n)
        b.add_request(p, max_new_tokens=n)
    want, got = a.run(), b.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert b.stats()["prefill_chunks"] == a.stats()["prefill_chunks"]
    with pytest.raises(ValueError, match="exceeds the engine context"):
        b.add_request(rs.randint(0, 96, (60,)), max_new_tokens=5)
    # the static engine at the table's end
    p = rs.randint(0, 96, (1, 58))
    np.testing.assert_array_equal(
        port.generate(torch.from_numpy(p), max_new_tokens=6).numpy(),
        np.asarray(ref.generate(paddle.to_tensor(p),
                                max_new_tokens=6)._data))
