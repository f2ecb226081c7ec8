"""The port's paged decode attention against paddle_tpu's.

The plain version (`paged_decode_attention_reference`, what the CPU path
runs) must match paddle_tpu's Pallas kernel `paged_decode_attention_raw`
(interpret mode) and its XLA composition `paged_decode_attention_xla`, on
the shapes of tests/test_pallas_decode.py's `_setup`: f32 at <= 5e-5
(f32 accumulation on both sides), bf16 at 3e-2 (bf16 inputs and output
rounding), GQA, lengths 1 and full, negative table padding. The same holds for int8
caches with per-block scales and int4 caches packed two tokens per byte
(`k_scale`, `v_scale`, `kv_int4`), for MHA and GQA and lengths 1, full
and ragged; both reference functions, the Pallas kernel in interpret mode
included, run the int4 cases on the CPU. The CUDA kernels are held
against the plain version on the card in test_torch_cuda_kernels.py.
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


# -------------------------------------------- int8 / int4 caches (K7q)

def _setup_quant(fmt, s=3, hq=8, hkv=2, d=128, bs=16, pages=4, blocks=16,
                 lens=None, seed=0):
    """`_setup`'s queries, tables and lengths over an int8 cache of codes
    in -127..127, or an int4 cache of random packed bytes (every nibble
    -8..7), with random positive per-block scales."""
    q, _, _, tables, lens = _setup(s, hq, hkv, d, bs, pages, blocks, lens,
                                   seed)
    rs = np.random.RandomState(seed + 100)
    rows, lo, smax = (bs // 2, -128, 0.3) if fmt == "int4" \
        else (bs, -127, 0.015)
    kc = rs.randint(lo, 128, (blocks, hkv, rows, d)).astype(np.int8)
    vc = rs.randint(lo, 128, (blocks, hkv, rows, d)).astype(np.int8)
    ks = (rs.rand(blocks) * smax / 2 + smax / 2).astype("float32")
    vs = (rs.rand(blocks) * smax / 2 + smax / 2).astype("float32")
    return q, kc, vc, tables, lens, ks, vs


def _check_quant(fmt, args, dtype="float32", tol=5e-5):
    q, kc, vc, tables, lens, ks, vs = args
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    int4 = fmt == "int4"
    jx = [jnp.asarray(q, jdt)] + [jnp.asarray(a) for a in
                                  (kc, vc, tables, lens, ks, vs)]
    tt = [torch.from_numpy(q).to(tdt)] + [torch.from_numpy(a) for a in
                                          (kc, vc, tables, lens, ks, vs)]
    got = paged_decode_attention_reference(*tt, kv_int4=int4)
    assert got.dtype == tdt
    got = got.float().numpy()
    for fn in (paged_decode_attention_raw, paged_decode_attention_xla):
        want = np.asarray(fn(*jx, kv_int4=int4).astype(jnp.float32))
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=f"{fmt} {fn.__name__}")


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("heads", [(4, 4, 64), (8, 2, 128)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("lens", [[1, 1, 1], [64, 64, 64], [1, 23, 64]],
                         ids=["len1", "full", "ragged"])
def test_quantized_plain_matches_reference(fmt, heads, lens):
    hq, hkv, d = heads
    _check_quant(fmt, _setup_quant(fmt, hq=hq, hkv=hkv, d=d, lens=lens))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_plain_bf16_and_padding(fmt):
    args = list(_setup_quant(fmt, lens=[9, 3, 40]))
    tables = args[3].copy()
    tables[1, 1:] = -1           # pages past the length are padding
    tables[2, 3:] = -3
    args[3] = tables
    _check_quant(fmt, tuple(args), "bfloat16", 3e-2)


def test_int4_without_scales_raises():
    _, tt = _both(_setup(), "float32")
    with pytest.raises(ValueError, match="scales"):
        paged_decode_attention(*tt, kv_int4=True)
    with pytest.raises(ValueError, match="scales"):
        paged_decode_attention_reference(*tt, kv_int4=True)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_wrapper_takes_plain_version_on_cpu(fmt):
    q, kc, vc, tables, lens, ks, vs = _setup_quant(fmt)
    tt = [torch.from_numpy(a) for a in (q, kc, vc, tables, lens, ks, vs)]
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*tt, kv_int4=fmt == "int4")
    assert torch.equal(out, paged_decode_attention_reference(
        *tt, kv_int4=fmt == "int4"))
    assert not any(_cuda_common.launch_counts().values())
