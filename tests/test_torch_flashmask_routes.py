"""K9's static routes and its tensor-core wrapper path, checked on the CPU.

On the card each K9 C entry runs one body, chosen by entry, dtype and
head dim (`ops.flashmask.tensor_core_route`): the bf16 forward, dQ and
dK/dV at a head dim that pads to at most 128 run the tensor-core bodies
(csrc/flash_attention_tc.cuh, TMA), f32 and head dims above 128 the
CUDA-core ones. Here:
  * the route of every (entry, dtype, head dim) is pinned;
  * the CUDA wrapper path itself runs on CPU tensors with the C launch
    replaced by the plain versions, writing into the buffers the wrapper
    hands it: at d = 100 the tensor-core route pads q, k, v and dO to 104
    with the scale of the original d, and pads the lse and delta rows of
    dK/dV to a multiple of 4 floats (S = 130 and 70 are not multiples of
    4), while f32 and d = 192 take the tensors as they are. O, lse and
    the gradients equal the unpadded plain versions: bf16 outputs within
    one bf16 ulp (2^-7) of each one's largest |value| (the zero columns
    add exact zeros, only the summation order differs), lse within 1e-5;
  * the backward pads q, k, v and dO once: dQ and dK/dV are handed the
    same padded tensors.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flashmask as fm
from paddle_tpu_torch.ops.flash_attention import (attend_reference,
                                                  dkv_from_scores,
                                                  dq_from_scores,
                                                  scores_reference)

BF16, F32 = torch.bfloat16, torch.float32
ENTRIES = (fm._FWD, fm._BWD_DQ, fm._BWD_DKV)
#: (entry, dtype, head dim) -> runs a tensor-core body
ROUTES = [(n, dt, d, dt == BF16 and d <= 128)
          for n in ENTRIES for dt in (BF16, F32)
          for d in (64, 100, 124, 128, 130, 256)]


@pytest.mark.parametrize(
    "name,dtype,d,tensor_cores", ROUTES,
    ids=[f"{n.removeprefix('flashmask_')}-{str(dt).removeprefix('torch.')}"
         f"-d{d}" for n, dt, d, _ in ROUTES])
def test_route_table(name, dtype, d, tensor_cores):
    assert fm.tensor_core_route(name, dtype, d) is tensor_cores


def _fake_launch(seen):
    """Stands in for the C launch: computes the entry's plain version on
    the pointers' tensors (in the order `_launch` passes them) into the
    output buffers, after checking the lse / delta row stride."""
    def launch(name, ptrs, q, k, causal, scale, ints=()):
        sq = q.shape[2]
        scale = fm.softmax_scale(q.shape[3], scale)   # as `_launch` does
        seen.append((name, q.shape[-1], scale, ints,
                     tuple(t.data_ptr() for t in ptrs[:4])))
        if name == fm._FWD:
            q_, k_, v_, o, lse, start = ptrs[:6]
            ro, rlse = attend_reference(q_, k_, v_, fm._fm_mask(
                sq, k.shape[2], start, causal), scale)
            o.copy_(ro)
            lse.copy_(rlse)
            return
        q_, k_, v_, do, lse, delta = ptrs[:6]
        start = ptrs[-3]
        if name == fm._BWD_DKV:
            (stride,) = ints
            assert lse.shape[-1] == delta.shape[-1] == stride
            lse, delta = lse[..., :sq], delta[..., :sq]
        scores = scores_reference(q_, k_, v_, do, lse, delta, fm._fm_mask(
            sq, k.shape[2], start, causal), scale)
        if name == fm._BWD_DQ:
            ptrs[6].copy_(dq_from_scores(q_, scores))
        else:
            dk, dv = dkv_from_scores(q_, k_, v_, scores)
            ptrs[6].copy_(dk)
            ptrs[7].copy_(dv)
    return launch


@pytest.mark.parametrize("dtype,d,s", [(BF16, 100, 130), (BF16, 64, 70),
                                       (F32, 100, 130), (BF16, 192, 70)],
                         ids=["bf16-d100-s130", "bf16-d64-s70",
                              "f32-d100-s130", "bf16-d192-s70"])
def test_wrapper_pads_what_the_tensor_core_route_reads(monkeypatch, dtype,
                                                       d, s):
    rs = np.random.RandomState(d + s)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 2, s, d).astype("float32"))
                   .to(dtype) for _ in range(4))
    start = torch.from_numpy(np.minimum(
        np.arange(s) + 1 + rs.randint(0, s, (2, 2, s)), s).astype("int32"))
    want_o, want_lse = fm.flashmask_attention_reference(q, k, v, start, True)
    want = fm.flashmask_attention_bwd_reference(q, k, v, want_o, want_lse,
                                                do, start, True)
    seen = []
    monkeypatch.setattr(fm, "_launch", _fake_launch(seen))
    monkeypatch.setattr(fm, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fm, "_require_cuda", lambda *a: None)
    o, lse = fm.flashmask_fwd(q, k, v, start, True)
    grads = fm.flashmask_bwd(q, k, v, o, lse, do, start, True)
    tc = dtype == BF16 and d <= 128
    dp = -(-d // 8) * 8 if tc else d
    stride = -(-s // 4) * 4 if tc else s
    scale = 1 / np.sqrt(d)
    assert [(n, dd, ints) for n, dd, _, ints, _ in seen] == [
        (fm._FWD, dp, ()), (fm._BWD_DQ, dp, ()),
        (fm._BWD_DKV, dp, (stride,))]
    assert all(abs(sc - scale) < 1e-12 for _, _, sc, _, _ in seen)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    for g, w in zip((o, *grads), (want_o, *want)):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2 ** -7 * w.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,d", [(BF16, 100), (BF16, 64), (F32, 100)],
                         ids=["bf16-d100-padded", "bf16-d64", "f32-d100"])
def test_backward_pads_once_for_both_kernels(monkeypatch, dtype, d):
    """`flashmask_bwd` hands dQ and dK/dV the same q, k, v and dO: padded
    once to a multiple of 8 on the tensor-core route (d 100 -> 104, four
    pads in all), the caller's own tensors otherwise (no pad)."""
    rs = np.random.RandomState(d)
    s = 70
    q, k, v, do = (torch.from_numpy(rs.randn(1, 2, s, d).astype("float32"))
                   .to(dtype) for _ in range(4))
    start = torch.from_numpy(np.minimum(
        np.arange(s) + 1 + rs.randint(0, s, (1, 2, s)), s).astype("int32"))
    o, lse = fm.flashmask_attention_reference(q, k, v, start, True)
    seen = []
    monkeypatch.setattr(fm, "_launch", _fake_launch(seen))
    monkeypatch.setattr(fm, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fm, "_require_cuda", lambda *a: None)
    pad = torch.nn.functional.pad
    pads = []

    def counting_pad(t, *args, **kw):
        if t.dim() == 4:
            pads.append(tuple(t.shape))
        return pad(t, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "pad", counting_pad)
    fm.flashmask_bwd(q, k, v, o, lse, do, start, True)
    (dq_name, dq_d, *_, dq_ptrs), (dkv_name, dkv_d, *_, dkv_ptrs) = seen
    assert (dq_name, dkv_name) == (fm._BWD_DQ, fm._BWD_DKV)
    assert dq_ptrs == dkv_ptrs
    padded = dtype == BF16 and d % 8
    assert dq_d == dkv_d == (-(-d // 8) * 8 if padded else d)
    assert len(pads) == (4 if padded else 0)
    if not padded:
        assert dq_ptrs == tuple(t.data_ptr() for t in (q, k, v, do))
