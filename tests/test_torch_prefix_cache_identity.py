"""The port's engine with the prefix cache on against paddle_tpu's, end
to end, for the model-dtype cache (MHA, GQA): test_torch_prefix_cache.py's
`identity_with_cache_on` (greedy tokens and scheduler counters equal the
reference's with 8- and 16-token chunks), its modes split across files so
that they run on different workers.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_prefix_cache import _MODE_IDS, _MODES, identity_with_cache_on


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("kv_heads,kv_dtype", _MODES[:2], ids=_MODE_IDS[:2])
def test_greedy_token_identity_with_cache_on(kv_heads, kv_dtype, chunk):
    identity_with_cache_on(kv_heads, kv_dtype, chunk)
