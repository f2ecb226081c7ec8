"""The second half of test_torch_serving_quant.py's identity cases
(`IDENTITY_CASES[6:]`: greedy tokens equal paddle_tpu's engine with
quantized weights and KV caches), in a file of its own so that the two
halves run on different workers.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_serving_quant import IDENTITY_CASES
from test_torch_serving_quant import \
    test_greedy_token_identity_with_reference_engine as identity_case


@pytest.mark.parametrize("kv_heads,weight_quant,kv_cache_dtype,engine_kw",
                         IDENTITY_CASES[6:])
def test_greedy_token_identity_with_reference_engine(kv_heads, weight_quant,
                                                     kv_cache_dtype,
                                                     engine_kw):
    identity_case(kv_heads, weight_quant, kv_cache_dtype, engine_kw)
