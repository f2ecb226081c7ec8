"""The split-K paged decode (K7, K7q) on the CPU: its split count, its
partition-and-merge arithmetic against paddle_tpu, and the CUDA wrapper
path up to the C call.

On the card `paged_decode_attention` cuts each sequence's block table
into `decode_splits` partitions, one block each, and merges the blocks'
partial results (running max m, sum l, unnormalised accumulator) by the
log-sum-exp rule in split order. Here:
  * `decode_splits` is pinned: one split when the table is no wider than
    a partition, partitions of whole 64-token chunks covering the table,
    and a count that depends on the table's width, never on the lengths;
  * `paged_decode_split_reference`, the plain model of the kernel's
    arithmetic (k scales on the logits, v scales on the probabilities),
    matches paddle_tpu's `paged_decode_attention` (its XLA composition on
    the CPU; the Pallas kernel in interpret mode for one case) on the same
    numpy inputs, at lengths 0, 1, a page edge (16), a partition edge
    (256), one past it and the full table (512), GQA groups 1 and 3, bf16,
    int8 and int4 caches, and 1, 2, 4 and 3 splits. A row of length 0 is
    0, as the port's plain version makes it (the reference's composition
    softmaxes a fully masked row). Tolerances: f32 queries over int8 /
    int4 codes 1e-4 (both sides f32; the model scales each logit where
    the reference scales the cache); bf16 caches 3e-2 (the reference
    rounds scores and probabilities to bf16);
  * the CUDA wrapper path, run on CPU tensors with the C call replaced by
    a stand-in that checks its arguments and writes the model's result
    through the output pointer: the split count and partition are
    `decode_splits`' whatever the lengths, the workspace holds
    S * Hq * splits * (D + 2) floats, and one launch is counted.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import ctypes
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax.numpy as jnp
from paddle_tpu.ops.pallas_decode import (paged_decode_attention as
                                          tpu_paged_decode_attention,
                                          paged_decode_attention_raw)

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops import paged_decode as pd

BS, PAGES = 16, 32                    # a 512-token table
LENS = [0, 1, 16, 256, 257, 512]      # empty, 1, page / partition edges, full


# ------------------------------------------------------------ the count

@pytest.mark.parametrize("pages,bs,s_n,hkv,sm,want", [
    (16, 16, 8, 16, 132, (1, 256)),    # exactly one partition
    (9, 16, 8, 16, 132, (1, 192)),     # narrower: whole chunks
    (1, 8, 1, 1, 132, (1, 64)),
    (64, 16, 8, 16, 132, (4, 256)),    # the KERNEL shape: 512 blocks
    (256, 16, 2, 16, 132, (16, 256)),  # the long-context line
    (64, 16, 128, 16, 132, (1, 1024)),  # a large batch: partitions widen
    (256, 16, 64, 16, 132, (2, 2048)),
    (64, 16, 1, 1, 132, (4, 256)),
], ids=["one-partition", "narrower", "tiny", "kernel-shape", "long",
        "large-batch", "large-batch-long", "one-row"])
def test_decode_splits_pinned(pages, bs, s_n, hkv, sm, want):
    assert pd.decode_splits(pages, bs, s_n, hkv, sm) == want


def test_decode_splits_covers_the_table_in_whole_chunks():
    for pages in (1, 2, 7, 8, 9, 64, 100, 256, 4096):
        for bs in (8, 16, 32):
            for s_n, hkv in ((1, 1), (8, 16), (64, 8), (256, 32)):
                splits, part = pd.decode_splits(pages, bs, s_n, hkv, 132)
                width = pages * bs
                assert part % pd.CHUNK == 0 and part > 0
                assert splits * part >= width > (splits - 1) * part
                assert splits <= max(1, -(-width // pd.PARTITION))
                if width <= pd.PARTITION:
                    assert splits == 1


def test_decode_splits_reads_no_lengths():
    assert list(inspect.signature(pd.decode_splits).parameters) == [
        "pages", "bs", "s_n", "hkv", "sm_count"]


# ------------------------------------------ the arithmetic vs paddle_tpu

def _inputs(fmt, hq, hkv, d=64, seed=0):
    rs = np.random.RandomState(seed + hq)
    s_n, blocks = len(LENS), 1 + len(LENS) * PAGES
    q = rs.randn(s_n, hq, d).astype("float32")
    ids = rs.permutation(np.arange(1, blocks))[:s_n * PAGES]
    tables = ids.reshape(s_n, PAGES).astype("int32")
    tables[1, 1:] = -1                   # padding past the length
    lens = np.asarray(LENS, "int32")
    if fmt == "bf16":
        kc, vc = (rs.randn(blocks, hkv, BS, d).astype("float32")
                  for _ in range(2))
        return q, kc, vc, tables, lens, None, None
    rows, lo, smax = (BS // 2, -128, 0.3) if fmt == "int4" \
        else (BS, -127, 0.015)
    kc, vc = (rs.randint(lo, 128, (blocks, hkv, rows, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rs.rand(blocks) * smax / 2 + smax / 2).astype("float32")
              for _ in range(2))
    return q, kc, vc, tables, lens, ks, vs


def _torch_args(fmt, args):
    q, kc, vc, tables, lens, ks, vs = args
    if fmt == "bf16":
        return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kc, vc)] \
            + [torch.from_numpy(tables), torch.from_numpy(lens), None, None]
    return [torch.from_numpy(a) for a in (q, kc, vc, tables, lens, ks, vs)]


def _jax_args(fmt, args):
    q, kc, vc, tables, lens, ks, vs = args
    if fmt == "bf16":
        return [jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc)] \
            + [jnp.asarray(tables), jnp.asarray(lens), None, None]
    return [jnp.asarray(a) for a in (q, kc, vc, tables, lens, ks, vs)]


TOL = {"bf16": 3e-2, "int8": 1e-4, "int4": 1e-4}


@pytest.mark.parametrize("splits,part", [(1, 512), (2, 256), (4, 128),
                                         (3, 256)],
                         ids=["one-split", "two", "four", "three-last-empty"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (6, 2)], ids=["g1", "g3"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_split_model_matches_paddle_tpu(fmt, hq, hkv, splits, part):
    args = _inputs(fmt, hq, hkv)
    int4 = fmt == "int4"
    got = pd.paged_decode_split_reference(
        *_torch_args(fmt, args)[:5], splits, part,
        *_torch_args(fmt, args)[5:], kv_int4=int4)
    assert got.dtype == (torch.bfloat16 if fmt == "bf16" else torch.float32)
    got = got.float().numpy()
    want = np.asarray(tpu_paged_decode_attention(
        *_jax_args(fmt, args), kv_int4=int4).astype(jnp.float32))
    live = np.asarray(LENS) > 0
    np.testing.assert_allclose(got[live], want[live], atol=TOL[fmt], rtol=0)
    assert not got[~live].any()          # length 0: out = 0
    plain = pd.paged_decode_attention_reference(
        *_torch_args(fmt, args)[:5], *_torch_args(fmt, args)[5:],
        kv_int4=int4).float().numpy()
    np.testing.assert_allclose(got, plain, atol=TOL[fmt], rtol=0)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_split_model_matches_the_pallas_kernel(fmt):
    """The same inputs through paddle_tpu's Pallas kernel (interpret mode)
    at GQA group 3, two splits."""
    args = _inputs(fmt, 6, 2, seed=5)
    int4 = fmt == "int4"
    got = pd.paged_decode_split_reference(
        *_torch_args(fmt, args)[:5], 2, 256, *_torch_args(fmt, args)[5:],
        kv_int4=int4).numpy()
    want = np.asarray(paged_decode_attention_raw(*_jax_args(fmt, args),
                                                 kv_int4=int4))
    live = np.asarray(LENS) > 0
    np.testing.assert_allclose(got[live], want[live], atol=1e-4, rtol=0)


# ---------------------------------------------- the CUDA wrapper path

def _stand_in(seen, args, fmt):
    """The C entry: checks the split arguments against `decode_splits`,
    writes the split model's result through the output pointer."""
    q, kc, vc, tables, lens, ks, vs = args

    def entry(*a):
        scales = 0 if fmt == "model" else 2
        (out_ptr,) = a[5 + scales:6 + scales]
        s_n, hq, hkv, bs, d, pages, dtype, splits, part, ws, _stream = \
            a[6 + scales:]
        seen.append((splits, part, ws))
        res = pd.paged_decode_split_reference(
            q, kc, vc, tables, lens, splits, part, ks, vs,
            kv_int4=fmt == "int4").contiguous()
        ctypes.memmove(out_ptr, res.data_ptr(), res.numel() * 4)
        return 0
    return entry


@pytest.mark.parametrize("fmt", ["model", "int8", "int4"])
@pytest.mark.parametrize("lens", [[0, 1, 16, 256, 257, 512],
                                  [512] * 6],
                         ids=["ragged", "full"])
def test_wrapper_passes_splits_from_the_table_alone(monkeypatch, fmt, lens):
    args = list(_torch_args("bf16" if fmt == "model" else fmt,
                            _inputs("bf16" if fmt == "model" else fmt, 6, 2)))
    args[0] = args[0].float()
    if fmt == "model":
        args[1], args[2] = args[1].float(), args[2].float()
    args[4] = torch.tensor(lens, dtype=torch.int32)
    seen = []

    class Lib:
        pass

    lib = Lib()
    setattr(lib, pd.KERNEL_NAMES[fmt], _stand_in(seen, args, fmt))
    monkeypatch.setattr(pd, "kernel_library", lambda name: lib)
    monkeypatch.setattr(pd, "_ENTRIES", {})
    monkeypatch.setattr(pd, "_SM_COUNTS", {})
    monkeypatch.setattr(pd, "current_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132}))
    empty, sizes = torch.empty, []

    def recording_empty(*size, **kw):
        if kw.get("dtype") == torch.float32:
            sizes.append(size)
        return empty(*size, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    _cuda_common.reset_launch_counts()
    out = pd._launch(fmt, *args)
    s_n, hq, d = args[0].shape
    splits, part = pd.decode_splits(PAGES, BS, s_n, 2, 132)
    assert (splits, part) == (2, 256)
    ((got_splits, got_part, ws),) = seen
    assert (got_splits, got_part) == (splits, part) and ws
    assert sizes == [(s_n * hq * splits * (d + 2),)]
    assert _cuda_common.launch_counts()[pd.KERNEL_NAMES[fmt]] == 1
    want = pd.paged_decode_attention_reference(*args[:5], *args[5:],
                                               kv_int4=fmt == "int4")
    assert (out - want).abs().max().item() < 1e-4


def test_wrapper_reads_the_sm_count_once(monkeypatch):
    """The decode tick calls the wrapper once a layer: the card's SM count
    is read on the first call and kept for its device."""
    args = list(_torch_args("int8", _inputs("int8", 6, 2)))
    args[0] = args[0].float()
    seen, reads = [], []

    class Lib:
        pass

    lib = Lib()
    setattr(lib, pd.KERNEL_NAMES["int8"], _stand_in(seen, args, "int8"))
    monkeypatch.setattr(pd, "kernel_library", lambda name: lib)
    monkeypatch.setattr(pd, "current_stream", lambda dev: 0)
    monkeypatch.setattr(pd, "_ENTRIES", {})
    monkeypatch.setattr(pd, "_SM_COUNTS", {})

    def props(dev):
        reads.append(dev)
        return type("P", (), {"multi_processor_count": 132})

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    first = pd._launch("int8", *args)
    again = pd._launch("int8", *args)
    assert len(reads) == 1 and len(seen) == 2
    assert torch.equal(first, again)
