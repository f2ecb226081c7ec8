"""The port's paged decode attention against paddle_tpu's.

The plain version (`paged_decode_attention_reference`, what the CPU path
runs) must match paddle_tpu's Pallas kernel `paged_decode_attention_raw`
(interpret mode) and its XLA composition `paged_decode_attention_xla`, on
the shapes of tests/test_pallas_decode.py's `_setup`: f32 at <= 5e-5
(f32 accumulation on both sides), bf16 at 3e-2 (bf16 inputs and output
rounding), GQA, lengths 1 and full, negative table padding. The CUDA
kernel is held against the plain version on the card in
test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax.numpy as jnp
from paddle_tpu.ops.pallas_decode import (paged_decode_attention_raw,
                                          paged_decode_attention_xla)

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops.paged_decode import (
    paged_decode_attention, paged_decode_attention_reference)


def _setup(s=3, hq=8, hkv=2, d=128, bs=8, pages=4, blocks=16, lens=None,
           seed=0):
    """Random paged cache + disjoint block tables (block 0 left as trash),
    as tests/test_pallas_decode.py builds them."""
    rs = np.random.RandomState(seed)
    q = rs.randn(s, hq, d).astype("float32")
    kc = rs.randn(blocks, hkv, bs, d).astype("float32")
    vc = rs.randn(blocks, hkv, bs, d).astype("float32")
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = ids.reshape(s, pages).astype("int32")
    if lens is None:
        lens = rs.randint(1, pages * bs + 1, (s,))
    return q, kc, vc, tables, np.asarray(lens, "int32")


def _both(args, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, kc, vc, tables, lens = args
    jx = [jnp.asarray(a, jdt) for a in (q, kc, vc)] \
        + [jnp.asarray(tables), jnp.asarray(lens)]
    tt = [torch.from_numpy(a).to(tdt) for a in (q, kc, vc)] \
        + [torch.from_numpy(tables), torch.from_numpy(lens)]
    return jx, tt


def _check(args, dtype="float32", tol=5e-5):
    jx, tt = _both(args, dtype)
    got = paged_decode_attention_reference(*tt).float().numpy()
    for fn in (paged_decode_attention_raw, paged_decode_attention_xla):
        want = np.asarray(fn(*jx).astype(jnp.float32))
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5),
                                       ("bfloat16", 3e-2)])
def test_plain_matches_reference(dtype, tol):
    _check(_setup(), dtype, tol)


def test_mha_and_gqa_groups():
    _check(_setup(hq=4, hkv=4, d=64))
    _check(_setup(hq=8, hkv=1, d=64, seed=1))


@pytest.mark.parametrize("lens", [[1, 1, 1], [32, 32, 32], [1, 17, 32]],
                         ids=["len1", "full", "mixed"])
def test_length_edges(lens):
    _check(_setup(lens=lens))


def test_negative_table_padding_is_clamped():
    q, kc, vc, tables, lens = _setup(lens=[9, 3, 16])
    tables = tables.copy()
    tables[0, 2:] = -1       # pages past the length are padding
    tables[1, 1:] = -1
    tables[2, 2:] = -5
    _check((q, kc, vc, tables, lens))


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    _, tt = _both(_setup(), "float32")
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*tt)
    assert torch.equal(out, paged_decode_attention_reference(*tt))
    assert _cuda_common.launch_counts()["paged_decode_attention"] == 0
