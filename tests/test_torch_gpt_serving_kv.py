"""GPT serving in the port held to paddle_tpu on the CPU: the serving
engine with quantized weights and KV caches.

Tiny GPT (vocab 96, hidden 32, 2 layers, 4 heads, 64 positions, f32),
paddle_tpu's seeded init carried across by `gpt_from_numpy`, the prefix
cache off and whole prompts on both engines: greedy tokens equal the
reference engine's for int8 and int4 weights, int8 and int4 KV caches
and both at int4, with `param_bytes`, `kv_hbm_bytes` and the tick counts
equal.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.text.models.gpt import GPTConfig as RConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RGPT

from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.text.models import GPTConfig, gpt_from_numpy

_KW = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)
_PAIR: list = []
_OFF = dict(prefix_cache=False, chunked_prefill_tokens=0)


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


@pytest.mark.parametrize("weight_quant,kv", [
    ("int8", "model"), ("int4", "model"), ("none", "int8"),
    ("none", "int4"), ("int4", "int4")])
def test_engine_quantized_identity(weight_quant, kv):
    rs = np.random.RandomState(3)
    prompts = [(rs.randint(0, 96, (ln,)), nt)
               for ln, nt in ((3, 5), (9, 6), (5, 4))]
    want, got, a, b = _run_both(dict(weight_quant=weight_quant,
                                     kv_cache_dtype=kv, **_OFF), prompts)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    sa, sb = a.stats(), b.stats()
    for key in ("param_bytes", "kv_hbm_bytes", "kv_cache_mode",
                "weight_quant", "decode_tokens", "steps"):
        assert sb[key] == sa[key], key
