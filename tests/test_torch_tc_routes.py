"""The flash wrapper's static routes, checked on the CPU (no card needed).

On the card each C entry of the flash sources runs one body, chosen by
dtype and head dim (`_tensor_core_route`): every bf16 entry (K1, K1v, K2
and K2v dQ and dK/dV) at a head dim that pads to at most 128 runs the
tensor-core bodies of csrc/flash_attention_tc.cuh, which read by TMA and
so take a head dim padded to a multiple of 8 (`with_head_pad`) and, in
dK/dV, lse and delta rows padded to a multiple of 4 floats (`pad_rows`);
f32, and bf16 above 128, run the CUDA-core bodies. Here:
  * the route of every (entry, dtype, varlen, head dim) is pinned;
  * the lse/delta row padding keeps the first Sq columns as they were;
  * the padded varlen forward and backward through the plain versions
    equal the unpadded ones at d = 100, lengths of 0 and off multiples
    of 8 included: f32, zero columns add exact zeros to every dot, so
    only the summation order differs (O and each gradient within 1e-6 of
    its largest |value|, lse, a few units, within 1e-5).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import (
    _BWD_DKV, _BWD_DQ, _NAME, _tensor_core_route,
    flash_attention_bwd_reference, flash_attention_reference, pad_rows,
    softmax_scale, with_head_pad)

TOL_SAME = 1e-6

BF16, F32 = torch.bfloat16, torch.float32
#: (entry, dtype, varlen, head dim) -> runs a tensor-core body: every
#: (entry, dtype, varlen) at d 128, and at d 256 (CUDA cores in both
#: dtypes); bf16 at d 124 (pads to 128: tensor cores) and 130 (pads to
#: 136: CUDA cores)
ROUTES = [(n, dt, v, d, dt == BF16 and d <= 128)
          for n in (_NAME, _BWD_DQ, _BWD_DKV) for dt in (BF16, F32)
          for v in (False, True) for d in (128, 256)] \
    + [(n, BF16, v, d, d == 124) for n in (_NAME, _BWD_DQ, _BWD_DKV)
       for v in (False, True) for d in (124, 130)]


@pytest.mark.parametrize(
    "name,dtype,varlen,d,tensor_cores", ROUTES,
    ids=[f"{n.removeprefix('flash_attention_')}-"
         f"{str(dt).removeprefix('torch.')}-{'varlen' if v else 'dense'}-d{d}"
         for n, dt, v, d, _ in ROUTES])
def test_route_table(name, dtype, varlen, d, tensor_cores):
    assert _tensor_core_route(name, dtype, varlen, d) is tensor_cores


CASES = [(2, 2, 70, True, [70, 33]), (4, 2, 96, False, [41, 0, 96]),
         (2, 1, 130, True, [0, 129, 64, 7])]
IDS = ["causal", "gqa-full-empty", "mqa-causal-empty"]


@pytest.mark.parametrize("hq,hkv,s,causal,lens", CASES, ids=IDS)
def test_padded_varlen_forward_equals_unpadded(hq, hkv, s, causal, lens):
    d = 100
    rs = np.random.RandomState(31)
    b = len(lens)
    q = torch.from_numpy(rs.randn(b, hq, s, d).astype("float32"))
    k, v = (torch.from_numpy(rs.randn(b, hkv, s, d).astype("float32"))
            for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    seen = []

    def run(q_, k_, v_, scale):
        seen.append((q_.shape[-1], scale))
        return flash_attention_reference(q_, k_, v_, causal, kv_lens, scale)

    o, lse = with_head_pad(run, (q, k, v))
    # the kernel would see the padded head dim and the original scale
    assert seen == [(104, softmax_scale(d))]
    ro, rlse = flash_attention_reference(q, k, v, causal, kv_lens)
    assert o.shape == q.shape and o.is_contiguous()
    err = (o - ro).abs().max().item()
    assert err <= TOL_SAME * ro.abs().max().item(), err
    # lse of the rows that see a key is a few units; an empty row's -1e30
    # must match exactly
    assert (lse - rlse).abs().max().item() <= TOL_SAME * 10
    for i, n in enumerate(lens):
        if n == 0:
            assert (o[i] == 0).all() and (lse[i] == -1e30).all()


@pytest.mark.parametrize("sq", [70, 96, 130])
def test_lse_delta_rows_padded_to_four_floats(sq):
    """The dK/dV body reads lse and delta rows by TMA, whose row stride is
    a multiple of 16 bytes: rows go out ceil(Sq/4)*4 floats apart, the
    first Sq columns unchanged."""
    rows = torch.from_numpy(
        np.random.RandomState(sq).randn(2, 3, sq).astype("float32"))
    padded, stride = pad_rows(rows, 4)
    assert stride == -(-sq // 4) * 4 and stride % 4 == 0
    assert padded.shape == (2, 3, stride) and padded.is_contiguous()
    assert torch.equal(padded[..., :sq], rows)
    assert not padded[..., sq:].any()
    same, stride1 = pad_rows(rows, 1)
    assert stride1 == sq and same is rows


@pytest.mark.parametrize("hq,hkv,s,causal,lens", CASES, ids=IDS)
def test_padded_varlen_backward_equals_unpadded(hq, hkv, s, causal, lens):
    """K2v's route on the card: Q, K, V, O and dO padded from d = 100 to
    104, the scale of the original d, the gradients cut back to 100."""
    d = 100
    rs = np.random.RandomState(37)
    b = len(lens)
    q, do = (torch.from_numpy(rs.randn(b, hq, s, d).astype("float32"))
             for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(b, hkv, s, d).astype("float32"))
            for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    o, lse = flash_attention_reference(q, k, v, causal, kv_lens)
    seen = []

    def run(q_, k_, v_, o_, do_, scale):
        seen.append((q_.shape[-1], o_.shape[-1], do_.shape[-1], scale))
        return flash_attention_bwd_reference(q_, k_, v_, o_, lse, do_,
                                             causal, kv_lens, scale)

    got = with_head_pad(run, (q, k, v, o, do))
    assert seen == [(104, 104, 104, softmax_scale(d))]
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                         kv_lens)
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.shape == ref.shape and g.is_contiguous()
        err = (g - w).abs().max().item()
        assert err <= TOL_SAME * w.abs().max().item(), err
    for i, n in enumerate(lens):
        # no gradient reaches a key past the length
        assert not got[1][i, :, n:].any() and not got[2][i, :, n:].any()
        if n == 0:
            assert not got[0][i].any()
