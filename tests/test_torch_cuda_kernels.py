"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs a CUDA card (marker `cuda`) and skips without one.
The file imports neither jax nor paddle_tpu, so it runs where the port
runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` keeps tests/conftest.py, which sets up jax, out.) The
plain versions are themselves held against paddle_tpu in
test_torch_flash_attention.py, test_torch_paged_decode.py and
test_torch_quantized.py on the CPU. Tolerances: f32 1e-4 (f32
accumulation in another order); bf16 2e-2 (bf16 output rounding of
values of magnitude ~1, 2^-8 relative); f16 4e-3 (2^-11 relative, on
values up to a few), and f16 gradients 2^-9 of the largest |value| (each
side rounds its f32 sum once to f16). The dequant-matmul and the flash
backward are compared relative to the largest output (their outputs grow
with K and with the sequence): f32 1e-5 / 1e-4, bf16 2^-7 (each side
rounds its f32 sum once to bf16, so the two differ by at most one bf16
ulp, 2^-7 of a value's binade). The fused norm, rotary and SwiGLU kernels
(test_torch_fused_norm.py on the CPU) likewise, relative to each output's
largest |value|: f32 1e-5 (dw, a sum over rows in another order, 1e-4),
bf16 and f16 2^-7. The fused optimizer updates repeat their plain
versions' operations one by one, each rounded to nearest: they are held
to them bit for bit.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops import fused_norm, fused_optimizer
from paddle_tpu_torch.ops.flash_attention import (
    _bwd_delta, _launch_bwd_dkv, _launch_bwd_dq, flash_attention,
    flash_attention_bwd, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq_reference, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference)
from paddle_tpu_torch.ops.paged_decode import (
    KERNEL_NAMES, paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.ops.quantized import (dequant_int4, int4_unpack,
                                            quant_matmul, quant_matmul_raw,
                                            quant_matmul_reference,
                                            quantize_int4)

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2),
          (torch.float16, 4e-3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype("float32"))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 16, 16, 500, 500, 128, True), (2, 8, 2, 77, 77, 64, True),
    (1, 4, 4, 130, 130, 128, False), (1, 4, 1, 40, 100, 32, True)])
def test_flash_kernel_matches_plain(card, dtype, tol, b, hq, hkv, sq, sk, d,
                                    causal):
    rs = np.random.RandomState(0)
    q = _randn(rs, b, hq, sq, d).to(card, dtype)
    k = _randn(rs, b, hkv, sk, d).to(card, dtype)
    v = _randn(rs, b, hkv, sk, d).to(card, dtype)
    before = _cuda_common.launch_counts()["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()["flash_attention_fwd"] == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -7),
                                       (torch.float16, 2 ** -9)])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 16, 16, 500, 500, 128, True), (1, 16, 4, 512, 512, 128, True),
    (2, 8, 2, 77, 77, 64, True), (1, 4, 4, 130, 130, 128, False),
    (1, 4, 1, 100, 40, 32, True), (1, 4, 2, 40, 100, 16, False)],
    ids=["ragged", "gqa", "gqa-small", "full", "empty-rows", "full-sk"])
def test_flash_backward_kernels_match_plain(card, dtype, tol, b, hq, hkv, sq,
                                            sk, d, causal):
    rs = np.random.RandomState(5)
    q = _randn(rs, b, hq, sq, d).to(card, dtype)
    k = _randn(rs, b, hkv, sk, d).to(card, dtype)
    v = _randn(rs, b, hkv, sk, d).to(card, dtype)
    do = _randn(rs, b, hq, sq, d).to(card, dtype)
    o, lse = flash_attention_fwd(q, k, v, causal)
    before = _cuda_common.launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    after = _cuda_common.launch_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == ref.shape
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), err


@pytest.mark.parametrize("hq,hkv,s", [(16, 4, 512), (8, 8, 500)],
                         ids=["gqa", "ragged"])
def test_each_backward_kernel_matches_its_plain_version(card, hq, hkv, s):
    """The dQ and the dK/dV kernel, each launched alone, against its own
    plain version on the same bf16 inputs (one bf16 ulp of the largest
    value); each launch counts its own kernel and nothing else."""
    rs = np.random.RandomState(8)
    q, do = (_randn(rs, 1, hq, s, 128).to(card, torch.bfloat16)
             for _ in range(2))
    k, v = (_randn(rs, 1, hkv, s, 128).to(card, torch.bfloat16)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, True)
    args = (q, k, v, do, lse, _bwd_delta(o, do), True)
    for name, launch, plain in (
            ("flash_attention_bwd_dq", _launch_bwd_dq,
             flash_attention_bwd_dq_reference),
            ("flash_attention_bwd_dkv", _launch_bwd_dkv,
             flash_attention_bwd_dkv_reference)):
        before = _cuda_common.launch_counts()
        got, want = launch(*args), plain(*args)
        torch.cuda.synchronize()
        after = _cuda_common.launch_counts()
        assert {n: c - before[n] for n, c in after.items() if c != before[n]} \
            == {name: 1}
        if name == "flash_attention_bwd_dq":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            err = (g.float() - w.float()).abs().max().item()
            assert err <= 2 ** -7 * w.float().abs().max().item(), (name, err)


def test_flash_attention_op_on_card_matches_autograd_of_plain(card):
    """Gradients of the differentiable op (K1 forward, K2 backward) equal
    autograd through the plain forward, in f32; under no_grad the op is
    the forward kernel alone."""
    rs = np.random.RandomState(6)
    q, k, v = (_randn(rs, 2, h, 200, 64).to(card).requires_grad_()
               for h in (8, 2, 2))
    do = _randn(rs, 2, 8, 200, 64).to(card)
    _cuda_common.reset_launch_counts()
    o, _ = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(o, (q, k, v), do)
    ro, _ = flash_attention_reference(q, k, v, True)
    want = torch.autograd.grad(ro, (q, k, v), do)
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err
    counts = _cuda_common.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    with torch.no_grad():
        o2, _ = flash_attention(q, k, v, causal=True)
    assert o2.grad_fn is None
    assert _cuda_common.launch_counts()["flash_attention_fwd"] == 2
    assert _cuda_common.launch_counts()["flash_attention_bwd_dq"] == 1


#: bf16 K1, K1v and both K2 kernels run the tensor-core bodies (wgmma,
#: TMA): head dims 16-128 (100 through the wrapper's padding to 104),
#: Sq != Sk with empty rows, GQA 16:4, a ragged S and BERT's non-causal
#: shape
TC_CASES = [(1, 4, 4, 256, 256, 16, True), (1, 4, 4, 256, 256, 32, True),
            (1, 4, 4, 256, 256, 64, True), (2, 4, 2, 200, 200, 100, True),
            (1, 4, 4, 256, 256, 128, True), (1, 4, 2, 100, 40, 64, True),
            (1, 4, 2, 40, 100, 128, True), (1, 16, 4, 512, 512, 128, True),
            (1, 8, 8, 500, 500, 128, True), (64, 12, 12, 128, 128, 64, False)]
TC_IDS = ["d16", "d32", "d64", "d100-padded", "d128", "empty-rows",
          "sk-gt-sq", "gqa-16-4", "ragged-500", "bert"]


def _bf16_case(card, b, hq, hkv, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return (_randn(rs, b, hq, sq, d).to(card, torch.bfloat16),
            _randn(rs, b, hkv, sk, d).to(card, torch.bfloat16),
            _randn(rs, b, hkv, sk, d).to(card, torch.bfloat16),
            _randn(rs, b, hq, sq, d).to(card, torch.bfloat16))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", TC_CASES, ids=TC_IDS)
def test_bf16_tensor_core_forward_matches_plain(card, b, hq, hkv, sq, sk, d,
                                                causal):
    """K1's tensor-core body against its plain version: O within 2e-2
    (P is rounded to bf16 before PV, as the reference rounds it), lse
    within 1e-3 (taken from the f32 scores)."""
    q, k, v, _ = _bf16_case(card, b, hq, hkv, sq, sk, d, 11)
    before = _cuda_common.launch_counts()["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()["flash_attention_fwd"] == before + 1
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (o.float() - ro.float()).abs().max().item() < 2e-2
    assert (lse - rlse).abs().max().item() < 1e-3


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", TC_CASES, ids=TC_IDS)
def test_bf16_tensor_core_backward_matches_plain(card, b, hq, hkv, sq, sk, d,
                                                 causal):
    """K2's tensor-core dQ and dK/dV bodies, through the wrapper and its
    padding, against the plain backward: one bf16 ulp (2^-7) of each
    gradient's largest |value|; one launch of each."""
    q, k, v, do = _bf16_case(card, b, hq, hkv, sq, sk, d, 12)
    o, lse = flash_attention_fwd(q, k, v, causal)
    before = _cuda_common.launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    after = _cuda_common.launch_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    for name, g, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == ref.shape
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2 ** -7 * w.float().abs().max().item(), (name, err)


def test_bf16_dkv_repeats_bit_for_bit(card):
    """dK and dV sum the GQA group's q heads in registers in a fixed order
    (no atomics): two launches on the same inputs give the same bits."""
    q, k, v, do = _bf16_case(card, 2, 16, 4, 1024, 1024, 128, 13)
    o, lse = flash_attention_fwd(q, k, v, True)
    args = (q, k, v, do, lse, _bwd_delta(o, do), True)
    first = _launch_bwd_dkv(*args)
    second = _launch_bwd_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bf16_dq_repeats_bit_for_bit(card):
    """dQ sums its kv tiles in registers in a fixed order (no atomics):
    two launches on the same GQA inputs give the same bits."""
    q, k, v, do = _bf16_case(card, 2, 16, 4, 1024, 1024, 128, 14)
    o, lse = flash_attention_fwd(q, k, v, True)
    args = (q, k, v, do, lse, _bwd_delta(o, do), True)
    first = _launch_bwd_dq(*args)
    second = _launch_bwd_dq(*args)
    assert torch.equal(first, second)


#: K1v on the tensor-core forward: lengths off multiples of 64 and 128
#: (the last kv tile partial, real data past the length), a length of 0,
#: lengths inside one 128-key tile, GQA, causal and not, D 128 and 64
#: (100 through the wrapper's padding)
TC_VARLEN_CASES = [
    (4, 4, 300, 128, True, [300, 77, 0, 193]),
    (4, 2, 256, 128, False, [129, 1, 256, 0]),
    (16, 4, 520, 128, True, [520, 200, 65, 450]),
    (4, 4, 300, 64, True, [300, 77, 0, 193]),
    (8, 2, 200, 64, False, [63, 130, 0, 200]),
    (4, 2, 150, 100, True, [150, 3, 70])]
TC_VARLEN_IDS = ["d128-causal", "d128-full-gqa", "d128-gqa-16-4",
                 "d64-causal", "d64-full-gqa", "d100-padded"]


@pytest.mark.parametrize("hq,hkv,s,d,causal,lens", TC_VARLEN_CASES,
                         ids=TC_VARLEN_IDS)
def test_bf16_tensor_core_varlen_forward_matches_plain(card, hq, hkv, s, d,
                                                       causal, lens):
    """K1v's tensor-core forward against its plain version on every row
    (rows past a length included): O within 2e-2, lse within 1e-3; a
    sequence of length 0 gives O = 0 and lse = -1e30. One launch of the
    varlen forward, none of K1."""
    rs = np.random.RandomState(23)
    b = len(lens)
    q = _randn(rs, b, hq, s, d).to(card, torch.bfloat16)
    k, v = (_randn(rs, b, hkv, s, d).to(card, torch.bfloat16)
            for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=card)
    before = _cuda_common.launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal, kv_lens)
    ro, rlse = flash_attention_reference(q, k, v, causal, kv_lens)
    torch.cuda.synchronize()
    after = _cuda_common.launch_counts()
    assert {n: c - before[n] for n, c in after.items() if c != before[n]} \
        == {"flash_attention_varlen_fwd": 1}
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (o.float() - ro.float()).abs().max().item() < 2e-2
    assert (lse - rlse).abs().max().item() < 1e-3
    for i, n in enumerate(lens):
        if n == 0:
            assert (o[i] == 0).all() and (lse[i] == -1e30).all()


#: K2v on the tensor-core backward: S off multiples of 64 and 128 and
#: VARLEN's bucket, lengths of 0, inside one tile, on a tile edge, across
#: one and the whole row (clipped to S), MHA and GQA 8:2, D 64, 100
#: (through the wrapper's padding to 104) and 128; S 130 non-causal
TC_VARLEN_BWD_CASES = [(s, hq, hkv, d) for s in (70, 130, 2048)
                       for hq, hkv in ((8, 8), (8, 2)) for d in (64, 100, 128)]
TC_VARLEN_BWD_IDS = [f"s{s}-{'mha' if hq == hkv else 'gqa'}-d{d}"
                     for s, hq, hkv, d in TC_VARLEN_BWD_CASES]
K2V = ("flash_attention_varlen_fwd", "flash_attention_varlen_bwd_dq",
       "flash_attention_varlen_bwd_dkv")


def _bf16_varlen_case(card, hq, hkv, s, d, seed):
    lens = [min(n, s) for n in (0, 33, 64, 129, s)]
    q, k, v, do = _bf16_case(card, len(lens), hq, hkv, s, s, d, seed)
    return q, k, v, do, torch.tensor(lens, dtype=torch.int32, device=card)


@pytest.mark.parametrize("s,hq,hkv,d", TC_VARLEN_BWD_CASES,
                         ids=TC_VARLEN_BWD_IDS)
def test_bf16_tensor_core_varlen_backward_matches_plain(card, s, hq, hkv, d):
    """K2v's tensor-core dQ and dK/dV, through the wrapper (its head-dim
    and lse/delta row padding), against the plain backward on every row:
    one bf16 ulp (2^-7) of each gradient's largest |value|; dK and dV past
    each length exactly 0, and a length of 0 gives dQ = 0. One launch of
    each varlen entry (K1v, then K2v), none of K1 or K2."""
    causal = s != 130
    q, k, v, do, kv_lens = _bf16_varlen_case(card, hq, hkv, s, d, 24)
    _cuda_common.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal, kv_lens)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, kv_lens)
    torch.cuda.synchronize()
    assert _launched() == dict.fromkeys(K2V, 1)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                         kv_lens)
    for name, g, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == ref.shape
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2 ** -7 * w.float().abs().max().item(), (name, err)
    for i, n in enumerate(kv_lens.tolist()):
        assert not got[1][i, :, n:].any() and not got[2][i, :, n:].any()
        if n == 0:
            assert not got[0][i].any()


def test_bf16_varlen_backward_repeats_bit_for_bit(card):
    """K2v's dQ and dK/dV sum in registers in a fixed order (no atomics):
    two launches on the same GQA inputs with ragged lengths give the same
    bits."""
    q, k, v, do, kv_lens = _bf16_varlen_case(card, 16, 4, 1000, 128, 25)
    o, lse = flash_attention_fwd(q, k, v, True, kv_lens)
    args = (q, k, v, do, lse, _bwd_delta(o, do), True, kv_lens)
    assert torch.equal(_launch_bwd_dq(*args), _launch_bwd_dq(*args))
    first, second = _launch_bwd_dkv(*args), _launch_bwd_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bf16_varlen_backward_refuses_misaligned_inputs(card):
    """K2v's bf16 dQ and dK/dV read by TMA: a dO that starts 2 bytes past
    a 16-byte boundary is refused, not copied, and nothing launches."""
    k, v = (torch.randn(1, 2, 64, 64, device=card, dtype=torch.bfloat16)
            for _ in range(2))
    lens = torch.full((1,), 40, dtype=torch.int32, device=card)
    o, lse = flash_attention_fwd(k, k, v, True, lens)
    do = torch.randn(2 * 64 * 64 + 1, device=card,
                     dtype=torch.bfloat16)[1:].view(1, 2, 64, 64)
    assert do.is_contiguous() and do.data_ptr() % 16
    _cuda_common.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd(k, k, v, o, lse, do, True, lens)
    args = (k, k, v, do, lse, _bwd_delta(o, do), True, lens)
    with pytest.raises(ValueError, match="aligned"):
        _launch_bwd_dq(*args)
    with pytest.raises(ValueError, match="aligned"):
        _launch_bwd_dkv(*args)
    assert _launched() == {}


def test_tensor_core_route_refuses_misaligned_inputs(card):
    """The bf16 bodies read by TMA: a contiguous view that starts 2 bytes
    past a 16-byte boundary is refused, not copied, by K1, K1v and K2. f32
    runs the CUDA-core bodies, which take it."""
    n = 2 * 64 * 64

    def view(dtype):
        return torch.randn(n + 1, device=card).to(dtype)[1:].view(
            1, 2, 64, 64)

    q = view(torch.bfloat16)
    k, v, do = (torch.randn(1, 2, 64, 64, device=card, dtype=torch.bfloat16)
                for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(q, k, v)
    o, lse = flash_attention_fwd(k, k, v)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd(k, k, v, o, lse, view(torch.bfloat16))
    lens = torch.full((1,), 64, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(q, k, v, True, lens)
    q32, k32, v32 = view(torch.float32), k.float(), v.float()
    got, _ = flash_attention_fwd(q32, k32, v32)
    want, _ = flash_attention_reference(q32, k32, v32)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,hq,hkv,d,bs,pages,blocks", [
    (8, 16, 16, 128, 16, 64, 600), (5, 16, 2, 64, 8, 20, 120),
    (3, 8, 1, 32, 32, 3, 12)])
def test_paged_decode_kernel_matches_plain(card, dtype, tol, s, hq, hkv, d,
                                           bs, pages, blocks):
    rs = np.random.RandomState(1)
    q = _randn(rs, s, hq, d).to(card, dtype)
    kc = _randn(rs, blocks, hkv, bs, d).to(card, dtype)
    vc = _randn(rs, blocks, hkv, bs, d).to(card, dtype)
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = ids.reshape(s, pages).astype("int32")
    lens = rs.randint(1, pages * bs + 1, (s,)).astype("int32")
    lens[0] = 1
    tables[-1, (lens[-1] - 1) // bs + 1:] = -1      # padding past the end
    tables = torch.from_numpy(tables).to(card)
    lens = torch.from_numpy(lens).to(card)
    out = paged_decode_attention(q, kc, vc, tables, lens)
    ref = paged_decode_attention_reference(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,hq,hkv,d,bs,pages,blocks", [
    (8, 16, 16, 128, 16, 64, 600), (5, 16, 2, 64, 16, 20, 120),
    (3, 8, 1, 32, 32, 3, 12)])
def test_quantized_paged_decode_kernel_matches_plain(card, fmt, dtype, tol,
                                                     s, hq, hkv, d, bs,
                                                     pages, blocks):
    rs = np.random.RandomState(2)
    q = _randn(rs, s, hq, d).to(card, dtype)
    rows, lo, smax = (bs // 2, -128, 0.3) if fmt == "int4" \
        else (bs, -127, 0.015)
    kc, vc = (torch.from_numpy(rs.randint(lo, 128, (blocks, hkv, rows, d))
                               .astype(np.int8)).to(card) for _ in range(2))
    ks, vs = (torch.from_numpy((rs.rand(blocks) * smax / 2 + smax / 2)
                               .astype("float32")).to(card)
              for _ in range(2))
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = ids.reshape(s, pages).astype("int32")
    lens = rs.randint(1, pages * bs + 1, (s,)).astype("int32")
    lens[0] = 1
    tables[-1, (lens[-1] - 1) // bs + 1:] = -1      # padding past the end
    tables = torch.from_numpy(tables).to(card)
    lens = torch.from_numpy(lens).to(card)
    name = KERNEL_NAMES[fmt]
    before = _cuda_common.launch_counts()[name]
    args = (q, kc, vc, tables, lens, ks, vs)
    out = paged_decode_attention(*args, kv_int4=fmt == "int4")
    ref = paged_decode_attention_reference(*args, kv_int4=fmt == "int4")
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()[name] == before + 1
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 5504), (5504, 2048)],
                         ids=["qkvo", "gate-up", "down"])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 64, 128, 256, 512])
def test_quant_matmul_kernel_matches_plain(card, dtype, tol, m, k, n):
    """The 1B serve's three layer shapes at the decode slot buckets and
    the prefill buckets (bf16: the tensor-core body, every token tile,
    split and unsplit; f32: the CUDA-core body), against the plain
    version, and two calls give the same bits."""
    rs = np.random.RandomState(3)
    x = _randn(rs, m, k).to(card, dtype)
    packed, scale = quantize_int4(_randn(rs, k, n) * 0.05)
    packed, scale = packed.to(card), scale.to(card)
    before = _cuda_common.launch_counts()["quant_matmul"]
    out = quant_matmul_raw(x, packed, scale, k)
    again = quant_matmul_raw(x, packed, scale, k)
    ref = quant_matmul_reference(x, packed, scale, k)
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()["quant_matmul"] == before + 2
    assert out.dtype == dtype and tuple(out.shape) == (m, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("m,k,n", [(1, 2048, 32000), (8, 2048, 32000),
                                   (3, 64, 96), (17, 34, 32), (5, 34, 96),
                                   (130, 48, 160)])
def test_quant_matmul_other_shapes_match_plain(card, dtype, tol, m, k, n):
    """The lm_head's shape, one-slab K with a ragged column tile, and the
    shapes TMA cannot address (K = 34: bf16 takes the CUDA-core body).
    Each call launches K8 once, and two calls give the same bits."""
    rs = np.random.RandomState(3)
    x = _randn(rs, m, k).to(card, dtype)
    packed, scale = quantize_int4(_randn(rs, k, n) * 0.05)
    packed, scale = packed.to(card), scale.to(card)
    before = _cuda_common.launch_counts()["quant_matmul"]
    out = quant_matmul_raw(x, packed, scale, k)
    again = quant_matmul_raw(x, packed, scale, k)
    ref = quant_matmul_reference(x, packed, scale, k)
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()["quant_matmul"] == before + 2
    assert out.dtype == dtype and tuple(out.shape) == (m, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


def test_quant_matmul_refuses_what_it_does_not_take(card):
    rs = np.random.RandomState(4)
    packed, scale = quantize_int4(_randn(rs, 33, 64))     # odd K
    with pytest.raises(ValueError, match="even K"):
        quant_matmul_raw(torch.zeros(2, 33, device=card), packed.to(card),
                         scale.to(card), 33)
    packed, scale = quantize_int4(_randn(rs, 64, 48))     # N % 32
    with pytest.raises(ValueError, match="multiple of 32"):
        quant_matmul_raw(torch.zeros(2, 64, device=card), packed.to(card),
                         scale.to(card), 64)
    packed, scale = quantize_int4(_randn(rs, 64, 64))
    # the tensor-core body reads x by TMA: a bf16 x off a 16-byte
    # boundary raises, with no copy and no fallback
    xs = torch.zeros(2 * 64 + 1, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_matmul_raw(xs[1:].view(2, 64), packed.to(card),
                         scale.to(card), 64)
    with pytest.raises(ValueError, match="dtype"):
        quant_matmul_raw(torch.zeros(2, 64, device=card,
                                     dtype=torch.float16),
                         packed.to(card), scale.to(card), 64)
    # quant_matmul routes what the kernel does not take to the
    # reference's composition, on the card too, without launching K8
    cases = [(64, 64, 16, torch.float32), (33, 64, -1, torch.float32),
             (64, 48, -1, torch.bfloat16), (64, 64, -1, torch.float16)]
    for k, n, group, dtype in cases:
        packed, scale = quantize_int4(_randn(rs, k, n), group_size=group)
        x = _randn(rs, 3, k).to(dtype)
        if group > 0:
            want = x @ dequant_int4(packed, scale, k, dtype)
        else:
            want = (x @ int4_unpack(packed, k).to(dtype)) * scale.to(dtype)
        before = _cuda_common.launch_counts()["quant_matmul"]
        got = quant_matmul(x.to(card), packed.to(card), scale.to(card))
        torch.cuda.synchronize()
        assert _cuda_common.launch_counts()["quant_matmul"] == before
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.cpu().float() - want.float()).abs().max().item()
        assert err <= 2 ** -7 * want.float().abs().max().item(), (k, n, err)


def test_kernels_refuse_bad_inputs(card):
    q = torch.zeros(1, 2, 8, 16, device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=card)
    lse = torch.zeros(1, 2, 8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, q, q, q, lse, q.transpose(2, 3).contiguous()
                            .transpose(2, 3))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, lse.double(), q)
    qd = torch.zeros(2, 4, 16, device=card)
    kc = torch.zeros(4, 4, 8, 16, device=card)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(qd, kc, kc,
                               torch.zeros(2, 2, dtype=torch.int64,
                                           device=card),
                               torch.ones(2, dtype=torch.int32, device=card))


def test_engine_on_card_matches_cpu_engine(card):
    """Greedy tokens of a tiny f32 model served through both kernels on
    the card equal those of the same model on the CPU (plain versions)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card)
    gpu.set_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    stream = [(rs.randint(0, 256, (ln,)), nt)
              for ln, nt in ((3, 4), (20, 6), (2, 9), (40, 3), (4, 5))]
    out = []
    _cuda_common.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev)
        for p, nt in stream:
            eng.add_request(p, max_new_tokens=nt)
        out.append(eng.run())
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    counts = _cuda_common.launch_counts()
    assert counts["flash_attention_fwd"] == len(stream) * cfg.num_hidden_layers
    assert counts["paged_decode_attention"] > 0
    assert counts["flash_attention_bwd_dq"] == 0


def test_train_steps_on_card_match_cpu(card):
    """Five AdamW steps of a tiny f32 LLaMA on the card (K1 forward, K2
    backward) give the losses of the same steps on the CPU (plain
    versions) within 1e-4 relative, and K1/K2 launch once per layer and
    step."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    ids = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (2, 70)))
    losses = []
    for dev in ("cpu", card):
        torch.manual_seed(0)
        model = LlamaForCausalLM(cfg, device="cpu").to(dev)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        _cuda_common.reset_launch_counts()
        run = []
        for _ in range(5):
            loss = model(ids.to(dev), labels=ids.to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = _cuda_common.launch_counts()
    layers = cfg.num_hidden_layers
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "swiglu_fwd", "swiglu_bwd"):
        assert counts[name] == 5 * layers, counts
    for name in ("fused_rms_norm_fwd", "fused_rms_norm_bwd"):
        assert counts[name] == 5 * (2 * layers + 1), counts
    assert counts["rope_qk"] == 0, counts           # GQA: the composition


@pytest.mark.parametrize("weight_quant,kv_cache_dtype", [("int4", "int4"),
                                                         ("int8", "int8")])
def test_quantized_engine_on_card_matches_cpu_engine(card, weight_quant,
                                                     kv_cache_dtype):
    """Greedy tokens of a tiny f32 model served with quantized weights
    and KV cache through the kernels on the card equal those of the same
    model on the CPU (plain versions)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card)
    gpu.set_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    stream = [(rs.randint(0, 256, (ln,)), nt)
              for ln, nt in ((3, 4), (20, 6), (2, 9), (40, 3), (4, 5))]
    out = []
    _cuda_common.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev,
                            weight_quant=weight_quant,
                            kv_cache_dtype=kv_cache_dtype)
        for p, nt in stream:
            eng.add_request(p, max_new_tokens=nt)
        out.append(eng.run())
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    counts = _cuda_common.launch_counts()
    assert counts[KERNEL_NAMES[kv_cache_dtype]] > 0
    assert counts["paged_decode_attention"] == 0
    assert (counts["quant_matmul"] > 0) == (weight_quant == "int4")


@pytest.mark.parametrize("weight_quant,kv_cache_dtype", [
    ("none", "model"), ("int4", "int4"), ("int8", "int8")])
def test_prefix_cache_engine_on_card_matches_cpu_engine(card, weight_quant,
                                                        kv_cache_dtype):
    """The engine at its defaults but with 16-token chunks (prefix cache
    on): a stream sharing a 24-token prefix, a whole-prompt repeat (copy
    on write) and a long cold prompt, through the chunk program and the
    decode kernels on the card, gives the greedy tokens of the same tiny
    f32 model on the CPU, with the same scheduler counters."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card)
    gpu.set_state_dict(cpu.state_dict())
    rs = np.random.RandomState(4)
    shared = rs.randint(0, 256, (24,))
    prompts = [np.concatenate([shared, rs.randint(0, 256, (n,))])
               for n in (5, 8, 13)]
    prompts += [prompts[1].copy(), rs.randint(0, 256, (50,))]
    out, stats = [], []
    _cuda_common.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev,
                            chunked_prefill_tokens=16,
                            weight_quant=weight_quant,
                            kv_cache_dtype=kv_cache_dtype)
        for p in prompts[:1]:
            eng.add_request(p, max_new_tokens=4)
        eng.run()
        for p in prompts[1:]:
            eng.add_request(p, max_new_tokens=5)
        out.append(eng.run())
        stats.append(eng.stats())
        assert eng.prefix_cache.referenced_blocks == 0
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    for key in ("prefix_blocks_hit", "prefill_chunks", "steps",
                "kv_pool_free", "prefix_cached_blocks"):
        assert stats[1][key] == stats[0][key], key
    assert stats[1]["prefix_blocks_hit"] >= 9
    counts = _cuda_common.launch_counts()
    assert counts[KERNEL_NAMES[kv_cache_dtype]] \
        == stats[1]["steps"] * cfg.num_hidden_layers
    assert (counts["quant_matmul"] > 0) == (weight_quant == "int4")


def _graph_stream(seed=4):
    """Requests (prompt, new tokens) that reach every serving program at
    16-token chunks and 8-token blocks: short cold prompts (whole-prompt
    prefill), prompts behind a shared 24-token prefix (chunks behind
    cached blocks), a whole-prompt repeat (copy-on-write) and a cold
    50-token prompt (a chunk ladder)."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 256, (24,))
    prompts = [rs.randint(0, 256, (n,)) for n in (5, 11)]
    prompts += [np.concatenate([shared, rs.randint(0, 256, (n,))])
                for n in (5, 8, 13)]
    prompts += [prompts[3].copy(), rs.randint(0, 256, (50,)),
                rs.randint(0, 256, (3,))]
    return [(p, n) for p, n in zip(prompts, (4, 6, 4, 5, 3, 5, 4, 7))]


def _serve_graph_stream(model, dev, capture, stream, **kw):
    """`stream` through an engine on `dev` (prefix cache on, 16-token
    chunks), its first request alone to completion so that the rest hit
    its prefix; `capture` False runs the same programs eagerly. Returns
    (engine, outputs, launch counts of the run)."""
    from paddle_tpu_torch.inference import ServingEngine

    eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev,
                        chunked_prefill_tokens=16, **kw)
    eng._capture = capture and eng._capture
    _cuda_common.reset_launch_counts()
    rids = [eng.add_request(stream[0][0], max_new_tokens=stream[0][1])]
    eng.run()
    rids += [eng.add_request(p, max_new_tokens=n) for p, n in stream[1:]]
    out = eng.run()
    return eng, [out[r].tolist() for r in rids], \
        _cuda_common.launch_counts()


@pytest.mark.parametrize("weight_quant,kv_cache_dtype", [
    ("none", "model"), ("int4", "int4"), ("int8", "int8")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_engine_matches_eager_engine(card, dtype, weight_quant,
                                           kv_cache_dtype):
    """Every decode tick, whole-prompt prefill and chunk replays a CUDA
    graph captured once per key: a tiny LLaMA (f32 and bf16; bf16 and
    int4 weights through K1's and K8's tensor-core bodies) gives the
    eager engine's greedy tokens through them, with every kernel's
    launches equal to the eager run's (a replay adds what its capture
    launched), one graph per key of the CPU engine's table, and the
    prefix cache's copy-on-write inside the chunk graph."""
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card, dtype=dtype)
    gpu.set_state_dict(cpu.state_dict())
    stream = _graph_stream()
    kw = dict(weight_quant=weight_quant, kv_cache_dtype=kv_cache_dtype)
    on_cpu, cpu_out, _ = _serve_graph_stream(cpu, "cpu", False, stream,
                                             **kw)
    eager, want, want_counts = _serve_graph_stream(gpu, card, False, stream,
                                                   **kw)
    graph, got, counts = _serve_graph_stream(gpu, card, True, stream, **kw)
    assert got == want
    assert counts == want_counts
    assert counts[KERNEL_NAMES[kv_cache_dtype]] \
        == graph.stats()["steps"] * cfg.num_hidden_layers
    assert counts["flash_attention_fwd"] > 0
    assert (counts["quant_matmul"] > 0) == (weight_quant == "int4")
    st = graph._graph_stats()
    assert eager._graph_stats()["graphs_captured"] == {}
    assert set(graph._programs) == set(on_cpu._programs)
    assert sum(st["graphs_captured"].values()) == len(on_cpu._programs)
    assert set(st["graphs_captured"]) == {
        "serving.decode", "serving.prefill", "serving.chunk_prefill"}
    assert all(p.graph is not None for p in graph._programs.values())
    for key in ("prefix_blocks_hit", "prefill_chunks", "steps",
                "kv_pool_free", "prefix_cached_blocks"):
        assert graph.stats()[key] == eager.stats()[key], key
    assert graph.stats()["prefix_blocks_hit"] > 0
    assert graph.prefix_cache.referenced_blocks == 0
    if dtype == torch.float32:
        assert got == cpu_out


def test_graph_engine_sampling_repeats_and_keeps_greedy_rows(card):
    """A seeded mixed stream (sampling keys at every site: the sampling
    generator registered with each sampling graph) repeats between two
    graph engines with one seed; another seed draws other tokens; the
    greedy requests keep the eager engine's tokens."""
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    gpu = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                           device=card)
    stream = _graph_stream(5)
    sampled = (0, 3, 6)

    def run(capture, seed):
        from paddle_tpu_torch.inference import ServingEngine

        eng = ServingEngine(gpu, max_slots=2, kv_block_size=8, device=card,
                            chunked_prefill_tokens=16, seed=seed)
        eng._capture = capture
        rids = [eng.add_request(p, max_new_tokens=n, do_sample=i in sampled,
                                temperature=1.3, top_k=40, top_p=0.95)
                for i, (p, n) in enumerate(stream)]
        out = eng.run()
        return eng, [out[r].tolist() for r in rids]

    eng, a = run(True, 7)
    _, b = run(True, 7)
    _, c = run(True, 8)
    _, eager = run(False, 7)
    assert a == b
    assert any(a[i] != c[i] for i in sampled)
    for i in range(len(stream)):
        if i not in sampled:
            assert a[i] == eager[i], i
    assert any(k[2] for k in eng._programs)          # sampling keys ran


def test_dropped_graph_engines_leave_no_device_memory(card):
    """Engines that captured graphs and were dropped hand back all their
    device memory after a garbage collection: every engine on a device
    captures on one side stream (`engine._side_stream`), so torch keeps
    one cuBLAS workspace for it, not one per engine (32 MiB each on sm90,
    until the process ends). The first engine may leave that stream's
    workspace; the four after it leave nothing."""
    import gc

    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference import engine as engine_mod
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    gpu = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                           device=card, dtype=torch.bfloat16)
    left, streams = [], set()
    for i in range(5):
        eng = ServingEngine(gpu, max_slots=4, kv_block_size=8, device=card,
                            prefix_cache=False, chunked_prefill_tokens=0)
        rs = np.random.RandomState(i)
        for _ in range(3):
            eng.add_request(rs.randint(0, 256, (20,)), max_new_tokens=6)
        eng.run()
        streams.add(eng._stream)
        del eng
        gc.collect()
        torch.cuda.synchronize()
        left.append(torch.cuda.memory_allocated())
    assert len(streams) == 1
    assert streams == {engine_mod._side_stream(torch.device(card))}
    assert left[1:] == [left[1]] * 4, left


def test_graph_engine_captures_nothing_after_warmup(card):
    """Warm every bucket of an 8-slot stream, finish_warmup(), then 20
    steady ticks replay graphs only: zero captures, no new key."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    gpu = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                           device=card, dtype=torch.bfloat16)
    eng = ServingEngine(gpu, max_slots=8, kv_block_size=8, device=card)
    rs = np.random.RandomState(0)
    # slot buckets 1, 2, 4 and 8 and prompt bucket 16
    for n in range(8):
        eng.add_request(rs.randint(0, 256, (9,)), max_new_tokens=2 + 3 * n)
    eng.run()
    eng.finish_warmup()
    keys = set(eng._programs)
    for n in range(8):
        eng.add_request(rs.randint(0, 256, (12,)), max_new_tokens=24)
    ticks = 0
    while eng.has_work() and ticks < 30:
        eng.step()
        ticks += 1
    assert ticks >= 20
    st = eng._graph_stats()
    assert st["captures_after_warmup"] == 0, st
    assert set(eng._programs) == keys
    assert st["graphs_captured"]["serving.decode"] == 4


def _rel_err(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


_HALF_TOL = 2 ** -7


@pytest.mark.parametrize("x_dtype,y_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float16)])
@pytest.mark.parametrize("rows,h", [(66, 64), (66, 80), (7, 100),
                                    (600, 2048), (4099, 2048), (257, 1024),
                                    (257, 1032), (65, 2056), (33, 12288)])
@pytest.mark.parametrize("add", [False, True], ids=["rms", "add-rms"])
def test_fused_rms_norm_kernels_match_plain(card, x_dtype, y_dtype, rows, h,
                                            add):
    """K3 forward and backward against their plain versions from the same
    inputs (h = 100 in 2-byte types takes the backward's one-element
    path, the wide path); the backward's row kernel at LLaMA's width with
    rows off a multiple of its row ranges (4099), on each side of its
    layout switches (one warp a row up to 1024, two up to 2048, three
    past it) and at its widest row (MAX_HIDDEN, twelve warps, one staged
    row for f32 with ds); each launch counts its own kernel once."""
    rs = np.random.RandomState(rows + h)
    x, res, dy, ds = (_randn(rs, rows, h).to(card) for _ in range(4))
    x, res, ds = x.to(x_dtype), res.to(x_dtype), ds.to(x_dtype)
    dy = dy.to(y_dtype)
    w = _randn(rs, h).to(card, x_dtype)
    r = res if add else None
    before = _cuda_common.launch_counts()
    y, s, rstd = fused_norm.fused_rms_norm_fwd(x, r, w, 1e-6, y_dtype)
    want = fused_norm.rms_norm_fwd_reference(x, r, w, 1e-6, y_dtype)
    assert _rel_err(y, want[0]) <= (1e-5 if y_dtype == torch.float32
                                    else _HALF_TOL)
    if add:
        assert _rel_err(s, want[1]) <= (1e-6 if x_dtype == torch.float32
                                        else _HALF_TOL)
    else:
        assert s is None and want[1] is None
    assert _rel_err(rstd, want[2]) <= 1e-5
    saved = s if add else x
    dsum = ds if add else None
    dx, dw = fused_norm.fused_rms_norm_bwd(saved, w, rstd, dy, dsum)
    wdx, wdw = fused_norm.rms_norm_bwd_reference(saved, w, rstd, dy, dsum)
    torch.cuda.synchronize()
    half = x_dtype != torch.float32
    assert _rel_err(dx, wdx) <= (_HALF_TOL if half else 1e-5)
    assert _rel_err(dw, wdw) <= (_HALF_TOL if half else 1e-4)
    after = _cuda_common.launch_counts()
    assert {n: c - before[n] for n, c in after.items() if c != before[n]} \
        == {"fused_rms_norm_fwd": 1, "fused_rms_norm_bwd": 1}


@pytest.mark.parametrize("add", [False, True], ids=["rms", "add-rms"])
def test_fused_rms_norm_bwd_repeats_bit_for_bit(card, add):
    """dw is summed across rows in a fixed order (no atomics): two
    backward launches on the same inputs give the same bits, for the
    plain norm and the add variant (its ds added into dx)."""
    rs = np.random.RandomState(4)
    s, dy = (_randn(rs, 4096, 2048).to(card, torch.bfloat16)
             for _ in range(2))
    w = _randn(rs, 2048).to(card, torch.bfloat16)
    ds = _randn(rs, 4096, 2048).to(card, torch.bfloat16) if add else None
    _, _, rstd = fused_norm.fused_rms_norm_fwd(s, None, w, 1e-6)
    a = fused_norm.fused_rms_norm_bwd(s, w, rstd, dy, ds)
    b = fused_norm.fused_rms_norm_bwd(s, w, rstd, dy, ds)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(2, 33, 4, 16), (1, 17, 3, 6),
                                   (2, 256, 16, 128)],
                         ids=["tiny", "odd-half", "1b-heads"])
def test_rope_kernel_matches_plain(card, dtype, shape):
    """K4 both directions, random tables (the backward reads the partner
    index's sin); D/2 = 3 takes the one-element path."""
    rs = np.random.RandomState(shape[1])
    q, k = (_randn(rs, *shape).to(card, dtype) for _ in range(2))
    cos, sin = (_randn(rs, shape[1], shape[3]).to(card, dtype)
                for _ in range(2))
    tol = 1e-5 if dtype == torch.float32 else _HALF_TOL
    for backward in (False, True):
        before = _cuda_common.launch_counts()["rope_qk"]
        got = fused_norm.rope_qk(q, k, cos, sin, backward)
        want = fused_norm.rope_qk_reference(q, k, cos, sin, backward)
        torch.cuda.synchronize()
        assert _cuda_common.launch_counts()["rope_qk"] == before + 1
        for g, w in zip(got, want):
            assert _rel_err(g, w) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(66, 128), (3, 37), (512, 5504)])
def test_swiglu_kernels_match_plain(card, dtype, shape):
    """K5 forward and backward; 3 x 37 has a ragged tail after the
    vectors."""
    rs = np.random.RandomState(shape[1])
    g, u, do = (_randn(rs, *shape).to(card, dtype) for _ in range(3))
    tol = 1e-5 if dtype == torch.float32 else _HALF_TOL
    assert _rel_err(fused_norm.swiglu_fwd(g, u),
                    fused_norm.swiglu_fwd_reference(g, u)) <= tol
    for a, b in zip(fused_norm.swiglu_bwd(g, u, do),
                    fused_norm.swiglu_bwd_reference(g, u, do)):
        assert _rel_err(a, b) <= tol


def test_fused_ops_on_card_match_cpu(card):
    """The four raw entries (the autograd Functions over the kernels) give
    the CPU plain versions' outputs and gradients, in f32."""
    rs = np.random.RandomState(12)
    cpu = {"x": _randn(rs, 2, 33, 80), "r": _randn(rs, 2, 33, 80),
           "w": _randn(rs, 80), "q": _randn(rs, 2, 33, 4, 16),
           "k": _randn(rs, 2, 33, 4, 16), "c": _randn(rs, 1, 33, 1, 16),
           "s": _randn(rs, 1, 33, 1, 16)}

    def run(dev):
        t = {n: v.to(dev).requires_grad_(n not in "cs")
             for n, v in cpu.items()}
        outs = (fused_norm.rms_norm_raw(t["x"], t["w"]),
                *fused_norm.add_rms_norm_raw(t["x"], t["r"], t["w"]),
                *fused_norm.rope_qk_raw(t["q"], t["k"], t["c"], t["s"]),
                fused_norm.swiglu_raw(t["x"], t["r"]))
        loss = sum((o * torch.linspace(-1, 1, o.shape[-1], device=dev))
                   .square().sum() for o in outs)
        grads = torch.autograd.grad(loss, [t[n] for n in "xrwqk"])
        return [o.detach().cpu() for o in (*outs, *grads)]

    for got, want in zip(run(card), run("cpu")):
        assert _rel_err(got, want) <= 1e-4


def test_fused_kernels_refuse_bad_inputs(card):
    x = torch.zeros(4, 64, device=card)
    with pytest.raises(ValueError, match="weight"):
        fused_norm.fused_rms_norm_fwd(x, None, torch.zeros(64, device=card,
                                                           dtype=torch.half),
                                      1e-6)
    with pytest.raises(ValueError, match="output dtype"):
        fused_norm.fused_rms_norm_fwd(x, None, x[0], 1e-6, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_norm.fused_rms_norm_fwd(x.t().contiguous().t(), None,
                                      x[0], 1e-6)
    with pytest.raises(ValueError, match="one CUDA device|CPU"):
        fused_norm.swiglu_fwd(x, x.cpu())
    with pytest.raises(ValueError, match="one shape"):
        fused_norm.swiglu_fwd(x, x[:2])
    q = torch.zeros(1, 4, 2, 8, device=card)
    with pytest.raises(ValueError, match="tables"):
        fused_norm.rope_qk(q, q, torch.zeros(4, 4, device=card),
                           torch.zeros(4, 4, device=card))


def test_mha_train_steps_on_card_launch_every_fused_kernel(card):
    """Three AdamW steps of a tiny f32 MHA LLaMA on the card give the CPU
    losses within 1e-4 relative; K4 rotates Q and K once per layer and
    direction, K3 launches 2 x layers + 1 times each way, K5 once per
    layer each way."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    cfg = llama_tiny_config()
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (2, 70)))
    losses = []
    for dev in ("cpu", card):
        torch.manual_seed(0)
        model = LlamaForCausalLM(cfg, device="cpu").to(dev)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        _cuda_common.reset_launch_counts()
        run = []
        for _ in range(3):
            loss = model(ids.to(dev), labels=ids.to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = _cuda_common.launch_counts()
    layers = cfg.num_hidden_layers
    assert counts["rope_qk"] == 3 * 2 * layers, counts
    assert counts["fused_rms_norm_fwd"] == 3 * (2 * layers + 1), counts
    assert counts["fused_rms_norm_bwd"] == 3 * (2 * layers + 1), counts
    assert counts["swiglu_fwd"] == counts["swiglu_bwd"] == 3 * layers


@pytest.mark.parametrize("x_dtype,y_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
    (torch.float16, torch.float32)])
@pytest.mark.parametrize("rows,h", [(66, 64), (66, 80), (7, 100),
                                    (600, 768), (257, 1024), (4099, 1024),
                                    (8195, 768), (257, 1032), (65, 2048),
                                    (65, 2056), (33, 11264)])
@pytest.mark.parametrize("add", [False, True], ids=["ln", "add-ln"])
def test_fused_layer_norm_kernels_match_plain(card, x_dtype, y_dtype, rows,
                                              h, add):
    """K3-LN forward and backward against their plain versions from the
    same inputs, with a large common offset on every row (the E[x^2] -
    mean^2 variance); h = 100 in 2-byte types takes the backward's
    one-element path (the wide path), 768 a 96-thread forward block and
    three of a lane's four vectors in the backward's row kernel; GPT's
    and BERT's widths at rows off a multiple of the row kernel's row
    ranges (4099, 8195), each side of its layout switches (1024 / 1032,
    2048 / 2056) and its widest row (MAX_HIDDEN_LN, eleven warps). Each
    launch counts its own kernel once."""
    rs = np.random.RandomState(rows + h)
    x, res, dy, ds = (_randn(rs, rows, h).to(card) for _ in range(4))
    x = (x + 4.0).to(x_dtype)
    res, ds, dy = res.to(x_dtype), ds.to(x_dtype), dy.to(y_dtype)
    w, b = (_randn(rs, h).to(card) for _ in range(2))
    r = res if add else None
    before = _cuda_common.launch_counts()
    y, s, rstd, mean = fused_norm.fused_layer_norm_fwd(x, r, w, b, 1e-5,
                                                       y_dtype)
    want = fused_norm.layer_norm_fwd_reference(x, r, w, b, 1e-5, y_dtype)
    assert _rel_err(y, want[0]) <= (1e-5 if y_dtype == torch.float32
                                    else _HALF_TOL)
    if add:
        assert _rel_err(s, want[1]) <= (1e-6 if x_dtype == torch.float32
                                        else _HALF_TOL)
    else:
        assert s is None and want[1] is None
    assert _rel_err(rstd, want[2]) <= 1e-5
    assert _rel_err(mean, want[3]) <= 1e-5
    saved = s if add else x
    dsum = ds if add else None
    got = fused_norm.fused_layer_norm_bwd(saved, w, rstd, mean, dy, dsum)
    wants = fused_norm.layer_norm_bwd_reference(saved, w, rstd, mean, dy,
                                                dsum)
    torch.cuda.synchronize()
    half = x_dtype != torch.float32
    assert _rel_err(got[0], wants[0]) <= (_HALF_TOL if half else 1e-5)
    for g, wt in zip(got[1:], wants[1:]):      # dw, db: f32 sums over rows
        assert _rel_err(g, wt) <= 1e-4
    after = _cuda_common.launch_counts()
    assert {n: c - before[n] for n, c in after.items() if c != before[n]} \
        == {"fused_layer_norm_fwd": 1, "fused_layer_norm_bwd": 1}


@pytest.mark.parametrize("rows,h", [(4096, 1024), (8192, 768)],
                         ids=["gpt", "bert"])
@pytest.mark.parametrize("add", [False, True], ids=["ln", "add-ln"])
def test_fused_layer_norm_bwd_repeats_bit_for_bit(card, rows, h, add):
    """dw and db are summed across rows in a fixed order (no atomics):
    two backward launches on the same inputs give the same bits, for the
    plain norm and the add variant."""
    rs = np.random.RandomState(5)
    s, dy = (_randn(rs, rows, h).to(card, torch.bfloat16) for _ in range(2))
    w, b = (_randn(rs, h).to(card) for _ in range(2))
    ds = _randn(rs, rows, h).to(card, torch.bfloat16) if add else None
    _, _, rstd, mean = fused_norm.fused_layer_norm_fwd(s, None, w, b, 1e-5)
    one = fused_norm.fused_layer_norm_bwd(s, w, rstd, mean, dy, ds)
    two = fused_norm.fused_layer_norm_bwd(s, w, rstd, mean, dy, ds)
    assert all(torch.equal(u, v) for u, v in zip(one, two))


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("add", [False, True], ids=["plain", "add"])
def test_norm_bwd_off_16_bytes_takes_the_wide_path(card, kind, add):
    """A saved row that starts off 16 bytes (a contiguous view one
    element into its storage) is not 16-byte vectors: the backward plans
    the wide path (`norm_bwd_plan_for`) and matches its plain version, the
    same width's aligned rows plan the row kernel."""
    rows, h = 300, 1024
    rs = np.random.RandomState(17)
    flat = _randn(rs, rows * h + 1).to(card, torch.bfloat16)
    s = flat[1:].view(rows, h)
    dy, ds = (_randn(rs, rows, h).to(card, torch.bfloat16)
              for _ in range(2))
    ds = ds if add else None
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    top = fused_norm.MAX_HIDDEN if kind == "rms" else fused_norm.MAX_HIDDEN_LN
    assert fused_norm.norm_bwd_plan_for(s, None, dy, ds, top,
                                        sms).route == "wide"
    assert fused_norm.norm_bwd_plan_for(s.clone(), None, dy, ds, top,
                                        sms).route == "rows"
    if kind == "rms":
        w = _randn(rs, h).to(card, torch.bfloat16)
        _, _, rstd = fused_norm.fused_rms_norm_fwd(s, None, w, 1e-6)
        got = fused_norm.fused_rms_norm_bwd(s, w, rstd, dy, ds)
        want = fused_norm.rms_norm_bwd_reference(s, w, rstd, dy, ds)
        tols = (_HALF_TOL, _HALF_TOL)
    else:
        w, b = (_randn(rs, h).to(card) for _ in range(2))
        _, _, rstd, mean = fused_norm.fused_layer_norm_fwd(s, None, w, b,
                                                           1e-5)
        got = fused_norm.fused_layer_norm_bwd(s, w, rstd, mean, dy, ds)
        want = fused_norm.layer_norm_bwd_reference(s, w, rstd, mean, dy, ds)
        tols = (_HALF_TOL, 1e-4, 1e-4)
    torch.cuda.synchronize()
    for g, wt, tol in zip(got, want, tols):
        assert _rel_err(g, wt) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(66, 128), (3, 37), (8192, 768)])
def test_dropout_add_kernels_match_plain(card, dtype, shape):
    """K6 forward and backward against their plain versions, one 0/1
    mask; 3 x 37 has a ragged tail after the vectors."""
    rs = np.random.RandomState(shape[1])
    x, y, g = (_randn(rs, *shape).to(card, dtype) for _ in range(3))
    mask = torch.from_numpy((rs.rand(*shape) < 0.9).astype("float32")).to(
        card, dtype)
    scale = 1.0 / 0.9
    tol = 1e-5 if dtype == torch.float32 else _HALF_TOL
    before = _cuda_common.launch_counts()
    assert _rel_err(fused_norm.dropout_add_fwd(x, y, mask, scale),
                    fused_norm.dropout_add_fwd_reference(x, y, mask,
                                                         scale)) <= tol
    assert _rel_err(fused_norm.dropout_add_bwd(g, mask, scale),
                    fused_norm.dropout_add_bwd_reference(g, mask,
                                                         scale)) <= tol
    after = _cuda_common.launch_counts()
    assert {n: c - before[n] for n, c in after.items() if c != before[n]} \
        == {"dropout_add_fwd": 1, "dropout_add_bwd": 1}


def test_layer_norm_and_dropout_add_ops_on_card_match_cpu(card):
    """The LayerNorm and dropout + add raw entries (autograd Functions
    over K3-LN and K6) give the CPU plain versions' outputs and
    gradients, in f32, with one mask."""
    rs = np.random.RandomState(13)
    cpu = {"x": _randn(rs, 2, 33, 80), "r": _randn(rs, 2, 33, 80),
           "w": _randn(rs, 80), "b": _randn(rs, 80)}
    mask = torch.from_numpy((rs.rand(2, 33, 80) < 0.9).astype("float32"))

    def run(dev):
        t = {n: v.to(dev).requires_grad_() for n, v in cpu.items()}
        outs = (fused_norm.layer_norm_raw(t["x"], t["w"], t["b"]),
                *fused_norm.add_layer_norm_raw(t["x"], t["r"], t["w"],
                                               t["b"]),
                fused_norm.dropout_add_raw(t["x"], t["r"], mask.to(dev),
                                           1 / 0.9))
        loss = sum((o * torch.linspace(-1, 1, o.shape[-1], device=dev))
                   .square().sum() for o in outs)
        grads = torch.autograd.grad(loss, [t[n] for n in "xrwb"])
        return [o.detach().cpu() for o in (*outs, *grads)]

    for got, want in zip(run(card), run("cpu")):
        assert _rel_err(got, want) <= 1e-4


def test_layer_norm_kernels_refuse_bad_inputs(card):
    x = torch.zeros(4, 64, device=card)
    with pytest.raises(ValueError, match="weight"):
        fused_norm.fused_layer_norm_fwd(x, None, x[0].half(), x[0], 1e-5)
    with pytest.raises(ValueError, match="rows of"):
        empty = torch.zeros(0, 64, device=card)
        fused_norm.fused_layer_norm_fwd(empty, None, x[0], x[0], 1e-5)
    with pytest.raises(ValueError, match="one shape"):
        fused_norm.dropout_add_fwd(x, x[:2], x, 1.0)


def _tiny_train(make, batch, dev, steps=3):
    """`steps` AdamW steps of the model `make(device)` builds on `dev`
    (labels from `batch(dev)`), from zeroed launch counts: the losses."""
    from paddle_tpu_torch.optimizer import AdamW

    torch.manual_seed(0)
    model = make("cpu").to(dev)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    ids, labels = batch(dev)
    _cuda_common.reset_launch_counts()
    losses = []
    for _ in range(steps):
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def test_gpt_train_steps_on_card_launch_k1_k2_and_k3_ln(card):
    """Three AdamW steps of a tiny f32 GPT on the card give the CPU
    losses within 1e-4 relative; per step K1 and both K2 kernels launch
    once per layer, K3-LN 2 x layers + 1 times each way, the AdamW pass
    once per parameter (the per-parameter path), and no RMS, rotary,
    SwiGLU or dropout + add kernel."""
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (2, 70)))
    losses = [_tiny_train(lambda d: GPTForCausalLM(cfg, device=d),
                          lambda d: (ids.to(d), ids.to(d)), dev)
              for dev in ("cpu", card)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    layers = cfg.num_hidden_layers
    assert counts == {
        "flash_attention_fwd": 3 * layers, "flash_attention_bwd_dq":
        3 * layers, "flash_attention_bwd_dkv": 3 * layers,
        "fused_layer_norm_fwd": 3 * (2 * layers + 1),
        "fused_layer_norm_bwd": 3 * (2 * layers + 1),
        "fused_adam": 3 * len(list(GPTForCausalLM(
            cfg, device="cpu").parameters()))}, counts


def test_bert_train_steps_on_card_launch_k6_and_k3_ln(card):
    """Three AdamW steps of a tiny f32 BERT classifier with dropout 0.1
    on the card: per step K1 and both K2 kernels launch once per layer,
    K3-LN 2 x layers + 1 times each way, K6 2 x layers times each way and
    the AdamW pass once per parameter with a gradient (all but the token
    type embeddings, which no input selects); the losses are finite. With
    dropout 0 they equal the CPU's within 1e-4 relative."""
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)

    rs = np.random.RandomState(10)
    ids = torch.from_numpy(rs.randint(0, 256, (4, 40)))
    lab = torch.from_numpy(rs.randint(0, 2, (4,)))
    kw = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64)
    batch = lambda d: (ids.to(d), lab.to(d))  # noqa: E731
    cfg = BertConfig(**kw, hidden_dropout_prob=0.1)
    losses = _tiny_train(lambda d: BertForSequenceClassification(
        cfg, device=d), batch, card)
    assert np.isfinite(losses).all(), losses
    counts = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    layers = cfg.num_hidden_layers
    assert counts == {
        "flash_attention_fwd": 3 * layers, "flash_attention_bwd_dq":
        3 * layers, "flash_attention_bwd_dkv": 3 * layers,
        "fused_layer_norm_fwd": 3 * (2 * layers + 1),
        "fused_layer_norm_bwd": 3 * (2 * layers + 1),
        "dropout_add_fwd": 3 * 2 * layers,
        "dropout_add_bwd": 3 * 2 * layers,
        "fused_adam": 3 * (len(list(BertForSequenceClassification(
            cfg, device="cpu").parameters())) - 1)}, counts
    cfg = BertConfig(**kw, hidden_dropout_prob=0.0)
    losses = [_tiny_train(lambda d: BertForSequenceClassification(
        cfg, device=d), batch, dev) for dev in ("cpu", card)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


# ------------------------------------------- varlen (K1v/K2v), FlashMask (K9)

VARLEN = ("flash_attention_varlen_fwd", "flash_attention_varlen_bwd_dq",
          "flash_attention_varlen_bwd_dkv")
FLASHMASK = ("flashmask_fwd", "flashmask_bwd_dq", "flashmask_bwd_dkv")


def _launched():
    return {n: c for n, c in _cuda_common.launch_counts().items() if c}


def _check_grads(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * max(1.0, w.float().abs().max().item()), err


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 1e-4, 1e-4),
                                            (torch.bfloat16, 2e-2, 2 ** -7),
                                            (torch.float16, 4e-3, 2 ** -9)])
@pytest.mark.parametrize("hq,hkv,s,d,causal,lens", [
    (4, 2, 200, 64, True, [200, 77, 0, 130]),
    (4, 4, 256, 128, False, [256, 1, 64, 65]),
    (2, 2, 130, 32, True, [0, 0])],
    ids=["gqa-ragged-empty", "full", "all-empty"])
def test_varlen_kernels_match_plain(card, dtype, tol, gtol, hq, hkv, s, d,
                                    causal, lens):
    """K1v and both K2v kernels against their plain versions on every row
    (rows past a length included: both compute them), a sequence of
    length 0 giving o = 0, lse = -1e30 and no gradient; dK/dV past each
    length exactly 0. One launch of each varlen kernel, none of K1/K2."""
    rs = np.random.RandomState(21)
    b = len(lens)
    q, do = (_randn(rs, b, hq, s, d).to(card, dtype) for _ in range(2))
    k, v = (_randn(rs, b, hkv, s, d).to(card, dtype) for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=card)
    _cuda_common.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal, kv_lens)
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal, kv_lens)
    torch.cuda.synchronize()
    assert _launched() == dict.fromkeys(VARLEN, 1)
    ro, rlse = flash_attention_reference(q, k, v, causal, kv_lens)
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                         kv_lens)
    _check_grads(grads, want, gtol)
    for i, n in enumerate(lens):
        assert not grads[1][i, :, n:].any() and not grads[2][i, :, n:].any()
        if n == 0:
            assert (o[i] == 0).all() and (lse[i] == -1e30).all()
            assert not grads[0][i].any()


def test_varlen_op_on_card_matches_autograd_of_plain(card):
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_varlen_raw

    rs = np.random.RandomState(22)
    q, k, v = (_randn(rs, 3, h, 150, 64).to(card).requires_grad_()
               for h in (4, 2, 2))
    do = _randn(rs, 3, 4, 150, 64).to(card)
    kv_lens = torch.tensor([150, 3, 70], dtype=torch.int32, device=card)
    _cuda_common.reset_launch_counts()
    got = torch.autograd.grad(
        flash_attention_varlen_raw(q, k, v, kv_lens, True), (q, k, v), do)
    assert _launched() == dict.fromkeys(VARLEN, 1)
    ro, _ = flash_attention_reference(q, k, v, True, kv_lens)
    _check_grads(got, torch.autograd.grad(ro, (q, k, v), do), 1e-4)
    with torch.no_grad():
        flash_attention_varlen_raw(q, k, v, kv_lens, True)
    assert _launched()["flash_attention_varlen_fwd"] == 2


def _fm_starts(kind, b, h, s, rs):
    if kind == "window":
        st = np.minimum(np.arange(s) + 1024, s)
        return np.broadcast_to(st, (b, h, s)).astype("int32").copy()
    st = rs.randint(1, s + 1, (b, h, s)).astype("int32")
    if kind == "empty-row":
        st[0, 0] = 0              # every row of one head sees nothing
        st[-1, -1, :200] = 0      # whole hidden kv tiles elsewhere
    return st


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 1e-4, 1e-4),
                                            (torch.bfloat16, 2e-2, 2 ** -7),
                                            (torch.float16, 4e-3, 2 ** -9)])
@pytest.mark.parametrize("kind,b,h,s,d,causal", [
    ("random", 2, 2, 256, 64, True), ("random", 2, 2, 256, 64, False),
    ("empty-row", 2, 2, 300, 128, True), ("random", 1, 2, 4100, 64, True),
    ("window", 1, 2, 4100, 64, True)],
    ids=["random", "random-full", "empty-row", "ragged-4100",
         "window-4100"])
def test_flashmask_kernels_match_plain(card, dtype, tol, gtol, kind, b, h, s,
                                       d, causal):
    """K9's three kernels against their plain versions: random start rows
    (straddling tiles), a head whose rows all see nothing (o = 0, lse =
    -1e30, no gradient), hidden kv tiles (dK = dV = 0), S = 4100 (the
    ragged column tile), and a 1024-token window that skips most tiles.
    One launch of each, none of K1/K2."""
    from paddle_tpu_torch.ops.flashmask import (
        flashmask_attention_bwd_reference, flashmask_attention_reference,
        flashmask_bwd, flashmask_fwd)

    rs = np.random.RandomState(23)
    q, k, v, do = (_randn(rs, b, h, s, d).to(card, dtype) for _ in range(4))
    start = torch.from_numpy(_fm_starts(kind, b, h, s, rs)).to(card)
    _cuda_common.reset_launch_counts()
    o, lse = flashmask_fwd(q, k, v, start, causal)
    grads = flashmask_bwd(q, k, v, o, lse, do, start, causal)
    torch.cuda.synchronize()
    assert _launched() == dict.fromkeys(FLASHMASK, 1)
    ro, rlse = flashmask_attention_reference(q, k, v, start, causal)
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3
    _check_grads(grads, flashmask_attention_bwd_reference(
        q, k, v, o, lse, do, start, causal), gtol)
    if kind == "empty-row":
        assert (o[0, 0] == 0).all() and (lse[0, 0] == -1e30).all()
        assert not grads[0][0, 0].any()
        assert not grads[1][-1, -1, :200].any()
        assert not grads[2][-1, -1, :200].any()


def test_flashmask_refuses_what_it_does_not_take(card):
    from paddle_tpu_torch.ops.flashmask import (flashmask_attention_raw,
                                                flashmask_fwd)

    q = torch.zeros(1, 4, 64, 32, device=card)
    k = torch.zeros(1, 2, 64, 32, device=card)
    st = torch.ones(1, 4, 64, dtype=torch.int32, device=card)
    _cuda_common.reset_launch_counts()
    with pytest.raises(ValueError, match="Hq == Hkv"):
        flashmask_attention_raw(q, k, k, st)
    with pytest.raises(ValueError, match="Hq == Hkv"):
        flashmask_fwd(q, k, k, st)
    with pytest.raises(ValueError, match="start_rows"):
        flashmask_fwd(q, q, q, st.long())
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention_fwd(q, q, q, True,
                            torch.ones(1, dtype=torch.int64, device=card))
    assert _launched() == {}


def test_varlen_and_flashmask_apis_on_card_match_cpu(card):
    """The public functions on the card against the same calls on the CPU
    (the plain versions), f32, with their launches: the kernel routes
    launch their kernels once each way, the composition and dense routes
    and dropout launch none of them."""
    from paddle_tpu_torch.incubate.nn.functional import \
        memory_efficient_attention
    from paddle_tpu_torch.nn import functional as PF

    rs = np.random.RandomState(24)
    cu = np.array([0, 100, 103, 300], dtype=np.int32)
    cu_k = np.array([0, 120, 140, 300], dtype=np.int32)
    x = [_randn(rs, 300, 4, 64) for _ in range(4)]
    idx = torch.from_numpy(np.minimum(
        np.arange(256) + 1 + rs.randint(0, 256, (2, 1, 256)), 256)
        .astype("int32"))[..., None]
    y = [_randn(rs, 2, 256, 4, 64) for _ in range(4)]

    def run(dev, fn, args, grad):
        leaves = [a.to(dev).requires_grad_() for a in args]
        _cuda_common.reset_launch_counts()
        out = fn(*leaves)
        gr = torch.autograd.grad(out, leaves, grad.to(dev))
        return [t.detach().cpu() for t in (out, *gr)], _launched()

    cases = [
        (lambda q, k, v: PF.flash_attn_unpadded(q, k, v, cu, cu, 197, 197,
                                                causal=True)[0], x[:3], x[3],
         dict.fromkeys(VARLEN, 1)),
        (lambda q, k, v: PF.flash_attn_unpadded(q, k, v, cu, cu_k, 197, 160,
                                                causal=True)[0], x[:3], x[3],
         {}),
        (lambda q, k, v: PF.flash_attn_varlen_qkvpacked(
            torch.stack([q, k, v], 1), cu, cu, 197, 197, scale=0.2)[0],
         x[:3], x[3], dict.fromkeys(VARLEN, 1)),
        (lambda q, k, v: memory_efficient_attention(
            q, k, v, cu_seqlens_q=cu, cu_seqlens_k=cu, max_seqlen_q=197,
            max_seqlen_k=197, causal=True), x[:3], x[3],
         dict.fromkeys(VARLEN, 1)),
        (lambda q, k, v: PF.flashmask_attention(q, k, v, idx.to(q.device),
                                                causal=True), y[:3], y[3],
         dict.fromkeys(FLASHMASK, 1)),
        (lambda q, k, v: PF.flashmask_attention(
            q, k[:, :, :2], v[:, :, :2], idx.to(q.device), causal=True),
         y[:3], y[3], {}),
    ]
    for fn, args, grad, want_counts in cases:
        (got, counts), (want, _) = (run(card, fn, args, grad),
                                    run("cpu", fn, args, grad))
        assert counts == want_counts, counts
        _check_grads(got, want, 1e-4)
    # dropout in training leaves the kernel routes
    _cuda_common.reset_launch_counts()
    q = x[0].to(card)
    out, _ = PF.flash_attn_unpadded(q, q, q, cu, cu, 197, 197, dropout=0.1)
    out2 = PF.flashmask_attention(y[0].to(card), y[1].to(card),
                                  y[2].to(card), idx.to(card), dropout=0.1,
                                  causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out2.shape == y[0].shape
    assert _launched() == {}


# ------------------------------------------------- faults F1-F4, K9 on TC

def _nan_pool(card):
    """Leave NaN-filled blocks in the caching allocator, so an output the
    kernel did not write would read NaN, not a lucky 0."""
    junk = [torch.full((n,), float("nan"), device=card)
            for n in (64, 256, 1024, 4096) for _ in range(8)]
    del junk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_with_no_keys_or_no_queries(card, dtype):
    """F4: a forward with Sk = 0 writes O = 0 and lse = -1e30, dQ with Sk
    = 0 writes dQ = 0 and dK/dV with Sq = 0 writes dK = dV = 0, in both
    dtypes (bf16 would otherwise reach the tensor-core bodies' TMA
    descriptors with a zero dimension), through the flash entries (K1,
    K1v, K2) and K9's; the f32 results are the reference."""
    from paddle_tpu_torch.ops.flashmask import flashmask_bwd, flashmask_fwd

    rs = np.random.RandomState(40)
    q = _randn(rs, 1, 2, 4, 64).to(card, dtype)
    kv0 = torch.zeros(1, 2, 0, 64, device=card, dtype=dtype)
    lens = torch.zeros(1, dtype=torch.int32, device=card)
    _nan_pool(card)
    for kl in (None, lens):
        o, lse = flash_attention_fwd(q, kv0, kv0, True, kl)
        torch.cuda.synchronize()
        assert o.shape == q.shape and not o.any()
        assert (lse == -1e30).all()
    do = _randn(rs, 1, 2, 4, 64).to(card, dtype)
    dq, dk, dv = flash_attention_bwd(q, kv0, kv0, o, lse, do, True)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and not dq.any()
    assert dk.shape == dv.shape == kv0.shape
    st0 = torch.zeros(1, 2, 0, dtype=torch.int32, device=card)
    o, lse = flashmask_fwd(q, kv0, kv0, st0, True)
    dq, _, _ = flashmask_bwd(q, kv0, kv0, o, lse, do, st0, True)
    torch.cuda.synchronize()
    assert not o.any() and (lse == -1e30).all() and not dq.any()
    # Sq = 0 under autograd: dK = dV = 0
    k, v = (_randn(rs, 1, 2, 5, 64).to(card, dtype).requires_grad_()
            for _ in range(2))
    q0 = torch.zeros(1, 2, 0, 64, device=card, dtype=dtype,
                     requires_grad=True)
    _nan_pool(card)
    out, _ = flash_attention(q0, k, v, causal=False)
    gk, gv = torch.autograd.grad(out.float().sum(), (k, v))
    torch.cuda.synchronize()
    assert out.shape == q0.shape
    assert not gk.any() and not gv.any()
    st = torch.full((1, 2, 5), 3, dtype=torch.int32, device=card)
    o0, l0 = flashmask_fwd(q0.detach(), k.detach(), v.detach(), st)
    _, gk, gv = flashmask_bwd(q0.detach(), k.detach(), v.detach(), o0, l0,
                              o0, st)
    torch.cuda.synchronize()
    assert not gk.any() and not gv.any()


#: F1: GQA groups off the templated ones (3, 6, 7 and 32) and head dims
#: up to 256
DECODE_FAULT_CASES = [(6, 2, 128), (12, 2, 64), (14, 2, 128), (32, 1, 128),
                      (8, 8, 256), (12, 4, 256), (32, 1, 256), (4, 4, 192),
                      (16, 4, 136)]
DECODE_FAULT_IDS = ["g3", "g6", "g7", "g32", "d256", "g3-d256", "g32-d256",
                    "d192", "d136"]


def _decode_inputs(card, rs, s, hq, hkv, d, bs, pages, blocks, dtype, fmt):
    q = _randn(rs, s, hq, d).to(card, dtype)
    if fmt == "model":
        kc, vc = (_randn(rs, blocks, hkv, bs, d).to(card, dtype)
                  for _ in range(2))
        scales = ()
    else:
        rows, lo, smax = (bs // 2, -128, 0.3) if fmt == "int4" \
            else (bs, -127, 0.015)
        kc, vc = (torch.from_numpy(rs.randint(lo, 128, (blocks, hkv, rows, d))
                                   .astype(np.int8)).to(card)
                  for _ in range(2))
        scales = tuple(torch.from_numpy((rs.rand(blocks) * smax / 2
                                         + smax / 2).astype("float32"))
                       .to(card) for _ in range(2))
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = torch.from_numpy(ids.reshape(s, pages).astype("int32")).to(card)
    lens = rs.randint(1, pages * bs + 1, (s,)).astype("int32")
    lens[0] = 1
    return (q, kc, vc, tables, torch.from_numpy(lens).to(card)) + scales


@pytest.mark.parametrize("fmt", ["model", "int8", "int4"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hq,hkv,d", DECODE_FAULT_CASES,
                         ids=DECODE_FAULT_IDS)
def test_paged_decode_takes_any_group_and_head_dims_to_256(card, fmt, dtype,
                                                           tol, hq, hkv, d):
    """F1: K7 / K7q at groups 3, 6, 7 and 32 (cut into the templated
    groups: 2 + 1, 4 + 2, 4 + 2 + 1, 16 + 16) and head dims 136-256 (the
    DM 256 instantiations, f32 caches in 32-token chunks; 136 has 8-byte
    int8/int4 rows), against the plain version: one call of the format's
    entry each, with the tolerances of the other decode tests."""
    rs = np.random.RandomState(hq * 1000 + d)
    args = _decode_inputs(card, rs, 5, hq, hkv, d, 16, 12, 80, dtype, fmt)
    kw = {"kv_int4": fmt == "int4"}
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*args[:5], *args[5:], **kw)
    ref = paged_decode_attention_reference(*args[:5], *args[5:], **kw)
    torch.cuda.synchronize()
    assert _launched() == {KERNEL_NAMES[fmt]: 1}
    assert out.dtype == dtype and out.shape == (5, hq, d)
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("fmt", ["model", "int8"])
def test_paged_decode_int8_rows_of_eight_bytes_and_plain_head_dims(card,
                                                                   fmt):
    """A head dim of 72 (8-byte int8 rows: 8-byte copies) runs the kernel;
    a head dim of 100 (no multiple of 8) takes the plain version on the
    card, as the reference's gate sends it to its composition, and
    launches nothing."""
    rs = np.random.RandomState(41)
    args = _decode_inputs(card, rs, 4, 8, 2, 72, 16, 6, 40, torch.bfloat16,
                          fmt)
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*args)
    ref = paged_decode_attention_reference(*args)
    torch.cuda.synchronize()
    assert _launched() == {KERNEL_NAMES[fmt]: 1}
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    args = _decode_inputs(card, rs, 4, 8, 2, 100, 16, 6, 40, torch.bfloat16,
                          fmt)
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert _launched() == {}
    assert torch.equal(out, paged_decode_attention_reference(*args))


@pytest.mark.parametrize("heads,kv_heads,hidden", [(6, 2, 96), (7, 1, 112),
                                                   (2, 2, 512)],
                         ids=["group3", "group7", "d256"])
def test_engine_on_card_serves_any_group_and_d256(card, heads, kv_heads,
                                                  hidden):
    """F1 end to end: tiny f32 LLaMAs with GQA groups 3 and 7 and with
    head dim 256 serve, through K1 and K7 on the card, the greedy tokens
    of the same model on the CPU."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(hidden_size=hidden, num_attention_heads=heads,
                            num_key_value_heads=kv_heads)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card)
    gpu.set_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    stream = [(rs.randint(0, 256, (ln,)), nt)
              for ln, nt in ((3, 4), (20, 6), (2, 9), (40, 3))]
    out = []
    _cuda_common.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev)
        for p, nt in stream:
            eng.add_request(p, max_new_tokens=nt)
        out.append(eng.run())
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    counts = _cuda_common.launch_counts()
    assert counts["flash_attention_fwd"] == len(stream) * cfg.num_hidden_layers
    assert counts["paged_decode_attention"] > 0


#: F2: head dims above 128 on the CUDA-core bodies' DM 256 instantiations
WIDE_D_CASES = [(1, 4, 4, 200, 200, 192, True), (2, 4, 2, 130, 130, 256, True),
                (1, 2, 2, 70, 150, 256, False), (1, 4, 1, 150, 70, 136, True)]
WIDE_D_IDS = ["d192", "d256-gqa", "d256-full", "d136-mqa-empty-rows"]


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 1e-4, 1e-4),
                                            (torch.bfloat16, 2e-2, 2 ** -7)])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", WIDE_D_CASES,
                         ids=WIDE_D_IDS)
def test_flash_takes_head_dims_to_256(card, dtype, tol, gtol, b, hq, hkv, sq,
                                      sk, d, causal):
    """F2: K1 and both K2 kernels at head dims 136-256 against the plain
    versions (O within `tol`, lse within 1e-3, each gradient within
    `gtol` of its largest |value|), one launch of each."""
    q, k, v, do = (t.to(dtype) for t in _bf16_case(card, b, hq, hkv, sq, sk,
                                                   d, 42))
    _cuda_common.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert _launched() == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal)
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3
    _check_grads(got, flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    causal), gtol)


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 1e-4, 1e-4),
                                            (torch.bfloat16, 2e-2, 2 ** -7)])
@pytest.mark.parametrize("d", [192, 256])
def test_varlen_and_flashmask_take_head_dims_to_256(card, dtype, tol, gtol,
                                                    d):
    """F2: K1v/K2v (lengths 0, 77 and S) and K9 (random start rows) at
    head dims 192 and 256 against the plain versions, one launch each."""
    from paddle_tpu_torch.ops.flashmask import (
        flashmask_attention_bwd_reference, flashmask_attention_reference,
        flashmask_bwd, flashmask_fwd)

    q, k, v, do = (t.to(dtype) for t in _bf16_case(card, 3, 2, 2, 140, 140,
                                                   d, 43))
    lens = torch.tensor([0, 77, 140], dtype=torch.int32, device=card)
    _cuda_common.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, True, lens)
    got = flash_attention_bwd(q, k, v, o, lse, do, True, lens)
    torch.cuda.synchronize()
    assert _launched() == dict.fromkeys(VARLEN, 1)
    ro, rlse = flash_attention_reference(q, k, v, True, lens)
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3
    _check_grads(got, flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    True, lens), gtol)
    rs = np.random.RandomState(44)
    st = torch.from_numpy(_fm_starts("random", 3, 2, 140, rs)).to(card)
    _cuda_common.reset_launch_counts()
    o, lse = flashmask_fwd(q, k, v, st, True)
    got = flashmask_bwd(q, k, v, o, lse, do, st, True)
    torch.cuda.synchronize()
    assert _launched() == dict.fromkeys(FLASHMASK, 1)
    ro, rlse = flashmask_attention_reference(q, k, v, st, True)
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3
    _check_grads(got, flashmask_attention_bwd_reference(
        q, k, v, o, lse, do, st, True), gtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,h", [("rms", 16384), ("rms", 65536),
                                    ("ln", fused_norm.MAX_HIDDEN_LN + 8),
                                    ("ln", 65536)])
def test_norms_take_wide_rows_through_nn_functional(card, dtype, kind, h):
    """F3: the routed norms and their add forms at rows wider than the
    shared-memory kernels hold (RMS 16384: LLaMA's widest hidden; LN
    11272; 65536: the forward's wide path too), forward and backward
    through nn.functional, against the same calls on the CPU (the plain
    versions): the kernels' tolerances relative to each output's largest
    |value| (dw, db: f32 sums over rows, 1e-4 unless rounded to bf16);
    one launch each way of each call."""
    from paddle_tpu_torch.nn import functional as PF

    rs = np.random.RandomState(h)
    rows = 24
    x, res, g = (_randn(rs, rows, h) for _ in range(3))
    w, b = _randn(rs, h), _randn(rs, h)
    if kind == "ln":
        x = x + 4.0
        fns = (lambda x_, r_, w_, b_: PF.layer_norm(x_, h, w_, b_),
               lambda x_, r_, w_, b_: PF.fused_add_layer_norm(x_, r_, w_,
                                                              b_)[0])
    else:
        fns = (lambda x_, r_, w_, b_: PF.rms_norm(x_, w_),
               lambda x_, r_, w_, b_: PF.fused_add_rms_norm(x_, r_, w_)[0])
    tol = 1e-5 if dtype == torch.float32 else _HALF_TOL
    # dw (db): f32 sums over rows, rounded to the weights' dtype (RMS: x's)
    wtol = tol if kind == "rms" and dtype != torch.float32 else 1e-4
    for fn in fns:
        outs = []
        for dev in ("cpu", card):
            leaves = [t.to(dev, dtype).requires_grad_() for t in (x, res)]
            wb = [t.to(dev, dtype if kind == "rms" else torch.float32)
                  .requires_grad_() for t in (w, b)]
            _cuda_common.reset_launch_counts()
            y = fn(*leaves, *wb)
            grads = torch.autograd.grad(y, leaves + wb, g.to(dev, y.dtype),
                                        allow_unused=True)
            outs.append((y, grads, _launched()))
        (y0, g0, _), (y1, g1, counts) = outs
        name = "fused_rms_norm" if kind == "rms" else "fused_layer_norm"
        assert counts == {f"{name}_fwd": 1, f"{name}_bwd": 1}, counts
        assert _rel_err(y1.cpu(), y0) <= tol
        for i, (a, e) in enumerate(zip(g1, g0)):
            if e is None:
                assert a is None
                continue
            assert _rel_err(a.cpu(), e) <= (tol if i < 2 else wtol)


def test_norms_send_empty_tensors_to_the_composition(card):
    """F3: a (0, H) input takes the plain composition on the card (the
    reference's `use_pallas` sends it there), forward and backward, and
    launches nothing."""
    from paddle_tpu_torch.nn import functional as PF

    x = torch.zeros(0, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.ones(64, device=card, dtype=torch.bfloat16)
    _cuda_common.reset_launch_counts()
    outs = [PF.rms_norm(x, w), PF.fused_add_rms_norm(x, x, w)[0],
            PF.layer_norm(x, 64, w, w), PF.fused_add_layer_norm(x, x, w,
                                                                w)[0]]
    grads = torch.autograd.grad(sum(o.float().sum() for o in outs), x)
    torch.cuda.synchronize()
    assert all(o.shape == (0, 64) for o in outs)
    assert grads[0].shape == (0, 64)
    assert _launched() == {}


#: K9 on the tensor-core forward and dK/dV (bf16, padded d <= 128): S off
#: multiples of 4 (70, 130, 4098), 64 and 128, a window and random
#: start rows, D 64, 100 (padded to 104) and 128
FM_TC_CASES = [("random", 70, 64), ("random", 130, 100), ("window", 200, 128),
               ("random", 200, 64), ("random", 4100, 128),
               ("window", 4100, 64), ("random", 4098, 100)]
FM_TC_IDS = [f"{k}-s{s}-d{d}" for k, s, d in FM_TC_CASES]


@pytest.mark.parametrize("kind,s,d", FM_TC_CASES, ids=FM_TC_IDS)
def test_flashmask_tensor_core_matches_plain(card, kind, s, d):
    """bf16 K9 forward, dQ and dK/dV on the tensor-core bodies against the
    plain versions: O within 2e-2, lse within 1e-3, each gradient within
    one bf16 ulp (2^-7) of its largest |value|;
    a column no row sees gets dK = dV = 0 and a row that sees no key O =
    0 and lse = -1e30. One launch of each K9 kernel."""
    from paddle_tpu_torch.ops.flashmask import (
        flashmask_attention_bwd_reference, flashmask_attention_reference,
        flashmask_bwd, flashmask_fwd)

    rs = np.random.RandomState(s + d)
    b, h = 2, 2
    q, k, v, do = (_randn(rs, b, h, s, d).to(card, torch.bfloat16)
                   for _ in range(4))
    st = _fm_starts(kind, b, h, s, rs)
    st[0, 0, 5] = 0               # a column no row sees
    st[1, 1, :] = np.minimum(st[1, 1, :], 3)   # rows >= 3 see no key
    start = torch.from_numpy(st).to(card)
    _cuda_common.reset_launch_counts()
    o, lse = flashmask_fwd(q, k, v, start, True)
    got = flashmask_bwd(q, k, v, o, lse, do, start, True)
    torch.cuda.synchronize()
    assert _launched() == dict.fromkeys(FLASHMASK, 1)
    ro, rlse = flashmask_attention_reference(q, k, v, start, True)
    assert (o.float() - ro.float()).abs().max().item() < 2e-2
    assert (lse - rlse).abs().max().item() < 1e-3
    want = flashmask_attention_bwd_reference(q, k, v, o, lse, do, start,
                                             True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2 ** -7 * w.float().abs().max().item(), (name, err)
    assert not got[1][0, 0, 5].any() and not got[2][0, 0, 5].any()
    assert (o[1, 1, 3:] == 0).all() and (lse[1, 1, 3:] == -1e30).all()


def test_flashmask_tensor_core_dkv_repeats_bit_for_bit(card):
    """K9's dK/dV sums its q tiles in registers in a fixed order (no
    atomics): two launches on the same inputs give the same bits."""
    from paddle_tpu_torch.ops.flash_attention import _bwd_delta
    from paddle_tpu_torch.ops.flashmask import (_launch_bwd_dkv, _launch_fwd,
                                                tile_bounds)

    rs = np.random.RandomState(45)
    q, k, v, do = (_randn(rs, 1, 4, 1030, 128).to(card, torch.bfloat16)
                   for _ in range(4))
    start = torch.from_numpy(_fm_starts("random", 1, 4, 1030, rs)).to(card)
    fm = (start, *tile_bounds(start, 1030), True)
    o, lse = _launch_fwd(q, k, v, *fm)
    args = (q, k, v, do, lse, _bwd_delta(o, do), *fm)
    first, second = _launch_bwd_dkv(*args), _launch_bwd_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flashmask_tensor_core_refuses_misaligned_inputs(card):
    """bf16 K9 forward, dQ and dK/dV read by TMA: a contiguous view that
    starts 2 bytes past a 16-byte boundary is refused, not copied, and
    nothing launches; f32 (CUDA-core bodies) takes it."""
    from paddle_tpu_torch.ops.flash_attention import _bwd_delta
    from paddle_tpu_torch.ops.flashmask import (
        _launch_bwd_dkv, _launch_bwd_dq, _launch_fwd,
        flashmask_attention_reference, flashmask_fwd, tile_bounds)

    n = 2 * 64 * 64
    q = torch.randn(n + 1, device=card).to(torch.bfloat16)[1:].view(
        1, 2, 64, 64)
    k, v = (torch.randn(1, 2, 64, 64, device=card, dtype=torch.bfloat16)
            for _ in range(2))
    st = torch.full((1, 2, 64), 40, dtype=torch.int32, device=card)
    assert q.is_contiguous() and q.data_ptr() % 16
    fm = (st, *tile_bounds(st, 64), True)
    _cuda_common.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        flashmask_fwd(q, k, v, st, True)
    with pytest.raises(ValueError, match="aligned"):
        _launch_fwd(q, k, v, *fm)
    assert _launched() == {}
    o, lse = flashmask_fwd(k, k, v, st, True)
    _cuda_common.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        _launch_bwd_dkv(k, k, v, q, lse, _bwd_delta(o, q), *fm)
    with pytest.raises(ValueError, match="aligned"):
        _launch_bwd_dq(k, k, v, q, lse, _bwd_delta(o, q), *fm)
    with pytest.raises(ValueError, match="aligned"):
        _launch_bwd_dq(q, k, v, k, lse, _bwd_delta(o, k), *fm)
    assert _launched() == {}
    q32 = torch.randn(n + 1, device=card)[1:].view(1, 2, 64, 64)
    got, _ = flashmask_fwd(q32, k.float(), v.float(), st, True)
    want, _ = flashmask_attention_reference(q32, k.float(), v.float(), st,
                                            True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 1e-4


#: K9 dQ on the tensor-core body (bf16, padded d <= 128): a 1024-token
#: window and random start rows, D 64, 72 (a multiple of 8 under 128: TMA
#: zero-fills the columns past it) and 128, S off a multiple of 128
FM_DQ_CASES = [(kind, s, d) for kind, s in (("window", 2100),
                                             ("random", 1030))
               for d in (64, 72, 128)]


@pytest.mark.parametrize("kind,s,d", FM_DQ_CASES,
                         ids=[f"{k}-s{s}-d{d}" for k, s, d in FM_DQ_CASES])
def test_flashmask_tensor_core_dq_matches_plain(card, kind, s, d):
    """bf16 K9 dQ (`flash_bwd_dq_tc_kernel<..., StartRowMask>`) against
    `flashmask_bwd_dq_reference` from the same inputs, within one bf16
    ulp (2^-7) of dQ's largest |value|: a row that sees no key gets dQ =
    0. One launch, and two launches give the same bits (dQ sums its kv
    tiles in registers in a fixed order)."""
    from paddle_tpu_torch.ops.flash_attention import _bwd_delta
    from paddle_tpu_torch.ops.flashmask import (
        _launch_bwd_dq, _launch_fwd, flashmask_bwd_dq_reference,
        tensor_core_route, tile_bounds)

    assert tensor_core_route("flashmask_bwd_dq", torch.bfloat16, d)
    rs = np.random.RandomState(s + d)
    b, h = 1, 2
    q, k, v, do = (_randn(rs, b, h, s, d).to(card, torch.bfloat16)
                   for _ in range(4))
    st = _fm_starts(kind, b, h, s, rs)
    st[0, 1, :] = np.minimum(st[0, 1, :], 5)    # rows >= 5 see no key
    start = torch.from_numpy(st).to(card)
    fm = (start, *tile_bounds(start, s), True)
    o, lse = _launch_fwd(q, k, v, *fm)
    delta = _bwd_delta(o, do)
    _cuda_common.reset_launch_counts()
    got = _launch_bwd_dq(q, k, v, do, lse, delta, *fm)
    again = _launch_bwd_dq(q, k, v, do, lse, delta, *fm)
    torch.cuda.synchronize()
    assert _launched() == {"flashmask_bwd_dq": 2}
    want = flashmask_bwd_dq_reference(q, k, v, do, lse, delta, start, True)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), err
    assert not got[0, 1, 5:].any()
    assert torch.equal(got, again)


#: split-K decode: lengths 0, 1, a partition edge (256), lengths that span
#: several partitions and end mid-chunk (700, 2733, 4095) and the full
#: 4096 in one batch over a 4096-token table (16 splits of 256), GQA
#: groups 1, 3 (2 + 1) and 16
DECODE_SPLIT_CASES = [(hq, hkv) for hq, hkv in ((8, 8), (12, 4), (16, 1))]
DECODE_SPLIT_LENS = [0, 1, 256, 700, 2733, 4095, 4096]


@pytest.mark.parametrize("fmt", ["model", "int8", "int4"])
@pytest.mark.parametrize("hq,hkv", DECODE_SPLIT_CASES,
                         ids=["g1", "g3", "g16"])
def test_split_decode_matches_plain_and_repeats(card, fmt, hq, hkv):
    """K7 / K7q split over the context (`decode_splits`: 16 partitions of
    256 tokens at this table width) against the plain version, bf16 q,
    each sequence within one bf16 ulp of its largest |output| (2^-7; 2^-6
    for the quantized formats, whose plain version also rounds the
    dequantized cache to bf16), as chip_smoke's DECODE_TOL: a dropped or
    misweighted partial of a long context moves it by far more. Length 0
    gives 0. One launch count per call, and two calls give the same bits
    (the partials merge in split order)."""
    from paddle_tpu_torch.ops.paged_decode import decode_splits

    rs = np.random.RandomState(hq * 10 + hkv)
    d, bs, pages = 128, 16, 256
    lens = DECODE_SPLIT_LENS
    args = _decode_inputs(card, rs, len(lens), hq, hkv, d, bs, pages,
                          1 + len(lens) * pages, torch.bfloat16, fmt)
    args = args[:4] + (torch.tensor(lens, dtype=torch.int32, device=card),) \
        + args[5:]
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert decode_splits(pages, bs, len(lens), hkv, sm)[0] > 1
    kw = {"kv_int4": fmt == "int4"}
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*args, **kw)
    again = paged_decode_attention(*args, **kw)
    ref = paged_decode_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    assert _launched() == {KERNEL_NAMES[fmt]: 2}
    tol = 2 ** -7 if fmt == "model" else 2 ** -6
    assert torch.isfinite(out.float()).all()
    diff = (out.float() - ref.float()).abs().flatten(1).amax(1)
    top = ref.float().abs().flatten(1).amax(1)
    assert (diff <= tol * top).all(), (diff / top).tolist()
    assert not out[0].any()
    assert torch.equal(out, again)


# ------------------------------------------- fused optimizer updates

#: (parameter dtype, state dtype, master weights): the pairs the
#: optimizers make (a 2-byte parameter beside f32 state without master
#: weights comes from a state dict loaded across precisions)
OPT_PAIRS = [(torch.float32, torch.float32, False),
             (torch.bfloat16, torch.bfloat16, False),
             (torch.bfloat16, torch.float32, True),
             (torch.bfloat16, torch.float32, False),
             (torch.float16, torch.float16, False),
             (torch.float16, torch.float32, True),
             (torch.float64, torch.float64, False)]
OPT_PAIR_IDS = ["f32", "bf16", "bf16-master", "bf16-f32state", "f16",
                "f16-master", "f64"]
#: sizes: single elements, a ragged vector tail, one over a chunk
#: boundary (kChunk 16384), and a misaligned view (offset by 1 element)
OPT_SIZES = [1, 7, 4096 + 3, 2 * 16384 + 5, 3, 100]


def _opt_lists(card, sizes, pdt, sdt, master, states, seed=0,
               misaligned=()):
    """Seeded parameters, gradients, `states` state lists (moments >= 0
    where they are second moments) and optional f32 master weights, on the
    card; the tensors at `misaligned` indices are views one element off
    their allocation's start."""
    rs = np.random.RandomState(seed)

    def put(a, dt, i):
        t = torch.from_numpy(a.astype("float32")).to(card, dt)
        if i in misaligned:
            buf = torch.empty(t.numel() + 1, dtype=dt, device=card)
            buf[1:].copy_(t)
            t = buf[1:]
        return t

    ps = [put(rs.randn(n) * 0.5, pdt, i) for i, n in enumerate(sizes)]
    gs = [put(rs.randn(n), pdt, i) for i, n in enumerate(sizes)]
    st = [[put(rs.rand(n) * (0.01 if k else 0.1), sdt, i)
           for i, n in enumerate(sizes)] for k in range(states)]
    ms = [p.float() + put(rs.randn(n) * 1e-3, torch.float32, i)
          for i, (p, n) in enumerate(zip(ps, sizes))] if master else None
    return ps, gs, st, ms


def _clone(xs):
    """Copies at the same offset from their allocation's start (a
    misaligned view stays misaligned)."""
    if xs is None:
        return None
    out = []
    for x in xs:
        off = x.storage_offset()
        buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
        out.append(buf[off:].view(x.shape).copy_(x))
    return out


def _same_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert torch.equal(x.view(-1).view(torch.uint8),
                           y.view(-1).view(torch.uint8))


ADAM_VARIANTS = {
    "adam-l2": dict(decoupled=False, coeffs=0.05),
    "adamw": dict(decoupled=True, coeffs=0.1),
    "adamw-amsgrad": dict(decoupled=True, coeffs=0.1, amsgrad=True),
    "adam-l1": dict(decoupled=False, coeffs=0.05, l1=True),
    "adamw-l1-amsgrad": dict(decoupled=True, coeffs=0.02, l1=True,
                             amsgrad=True),
    "adamw-scale": dict(decoupled=True, coeffs=0.1, scale=0.37),
}


@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
@pytest.mark.parametrize("pdt,sdt,master", OPT_PAIRS, ids=OPT_PAIR_IDS)
def test_fused_adam_matches_plain_bit_for_bit(card, pdt, sdt, master,
                                              variant):
    """fused_adam against fused_adam_reference on copies of the same
    inputs: every parameter, moment, moment2_max and master weight bit
    for bit; one launch; a second call on the same inputs gives the same
    bits."""
    v = dict(ADAM_VARIANTS[variant])
    ams, scale = v.pop("amsgrad", False), v.pop("scale", None)
    ps, gs, st, ms = _opt_lists(card, OPT_SIZES, pdt, sdt, master,
                                3 if ams else 2, misaligned=(4,))
    n = len(ps)
    lrs = [1e-3 * (1 + i % 3) for i in range(n)]
    coeff = v.pop("coeffs")
    coeffs = [0.0 if i == 1 else coeff for i in range(n)]
    if scale is not None:
        scale = torch.tensor([scale], device=card)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, step=7, scale=scale,
              **v)
    outs = []
    for fn in (fused_optimizer.fused_adam, fused_optimizer.fused_adam,
               fused_optimizer.fused_adam_reference):
        p, m1, m2 = _clone(ps), _clone(st[0]), _clone(st[1])
        mx, mw = _clone(st[2]) if ams else None, _clone(ms)
        before = _cuda_common.launch_counts()["fused_adam"]
        fn(p, _clone(gs), m1, m2, mx, mw, lrs, coeffs, **kw)
        torch.cuda.synchronize()
        launched = _cuda_common.launch_counts()["fused_adam"] - before
        assert launched == (fn is fused_optimizer.fused_adam)
        outs.append(p + m1 + m2 + (mx or []) + (mw or []))
    _same_bits(outs[0], outs[2])
    _same_bits(outs[0], outs[1])


@pytest.mark.parametrize("nesterov,coeff,l1,scale", [
    (False, 0.0, False, None), (True, 0.1, False, None),
    (False, 0.05, True, None), (True, 0.1, False, 0.5)],
    ids=["plain", "nesterov-l2", "l1", "nesterov-scale"])
@pytest.mark.parametrize("pdt,sdt,master", OPT_PAIRS, ids=OPT_PAIR_IDS)
def test_fused_momentum_matches_plain_bit_for_bit(card, pdt, sdt, master,
                                                  nesterov, coeff, l1,
                                                  scale):
    ps, gs, st, ms = _opt_lists(card, OPT_SIZES, pdt, sdt, master, 1,
                                seed=1, misaligned=(2,))
    n = len(ps)
    lrs = [0.05 * (1 + i % 2) for i in range(n)]
    kw = dict(momentum=0.9, nesterov=nesterov, l1=l1, scale=None
              if scale is None else torch.tensor(scale, device=card))
    outs = []
    for fn in (fused_optimizer.fused_momentum,
               fused_optimizer.fused_momentum,
               fused_optimizer.fused_momentum_reference):
        p, vel, mw = _clone(ps), _clone(st[0]), _clone(ms)
        before = _cuda_common.launch_counts()["fused_momentum"]
        fn(p, _clone(gs), vel, mw, lrs, [coeff] * n, **kw)
        torch.cuda.synchronize()
        launched = _cuda_common.launch_counts()["fused_momentum"] - before
        assert launched == (fn is fused_optimizer.fused_momentum)
        outs.append(p + vel + (mw or []))
    _same_bits(outs[0], outs[2])
    _same_bits(outs[0], outs[1])


def test_fused_adam_takes_long_lists(card):
    """250 tensors in one launch, and MAX_TENSORS + 10 in two, each bit
    for bit against the plain version."""
    for count, launches in ((250, 1),
                            (fused_optimizer.MAX_TENSORS + 10, 2)):
        sizes = [1 + (i * 37) % 3000 for i in range(count)]
        ps, gs, st, _ = _opt_lists(card, sizes, torch.bfloat16,
                                   torch.bfloat16, False, 2, seed=count)
        kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-6, step=3,
                  decoupled=True)
        lrs, coeffs = [1e-3] * count, [0.1] * count
        got = [_clone(ps), _clone(st[0]), _clone(st[1])]
        want = [_clone(ps), _clone(st[0]), _clone(st[1])]
        before = _cuda_common.launch_counts()["fused_adam"]
        fused_optimizer.fused_adam(got[0], gs, got[1], got[2], None, None,
                                   lrs, coeffs, **kw)
        torch.cuda.synchronize()
        assert _cuda_common.launch_counts()["fused_adam"] \
            == before + launches
        fused_optimizer.fused_adam_reference(want[0], gs, want[1], want[2],
                                             None, None, lrs, coeffs, **kw)
        for a, b in zip(got, want):
            _same_bits(a, b)


def test_fused_optimizer_refuses_what_it_does_not_take(card):
    f32 = dict(dtype=torch.float32, device=card)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, step=1, decoupled=True)

    def adam(p, g, m, v, masters=None):
        fused_optimizer.fused_adam([p], [g], [m], [v], None, masters,
                                   [0.1], [0.0], **kw)

    z = torch.zeros(8, **f32)
    with pytest.raises(ValueError, match="one CUDA device"):
        adam(z.clone(), torch.zeros(8), z.clone(), z.clone())
    with pytest.raises(ValueError, match="contiguous"):
        adam(torch.zeros(4, 2, **f32).t(), z.view(2, 4), z.clone(),
             z.clone())
    with pytest.raises(ValueError, match="dtype"):
        adam(z.clone(), z.to(torch.bfloat16), z.clone(), z.clone())
    with pytest.raises(ValueError, match="master"):
        adam(z.clone(), z.clone(), z.clone(), z.clone(), [z.clone()])
    with pytest.raises(ValueError, match="contiguous"):
        fused_optimizer.fused_momentum(
            [torch.zeros(4, 2, **f32).t()], [z.view(2, 4)], [z.view(2, 4)],
            None, [0.1], [0.0], momentum=0.9)


@pytest.mark.parametrize("cls", ["AdamW", "Momentum"])
def test_optimizer_paths_on_card_match_the_cpu(card, cls):
    """Three steps of the port's optimizer over f32 and bf16 parameters on
    the card, per parameter and fused (use_multi_tensor=True, one launch
    per dtype pair), against the same steps on the CPU (the plain
    versions): the parameters and state bit for bit, and the fused path
    launches twice a step. With global-norm clipping the card's two paths
    agree bit for bit (the norm's sum runs in another order on the
    CPU)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    rs = np.random.RandomState(3)
    shapes = [(64, 33), (33,), (7, 5), (1,)]
    inits = [rs.randn(*s).astype("float32") for s in shapes]
    grads = [[rs.randn(*s).astype("float32") for s in shapes]
             for _ in range(3)]
    runs = []
    for dev, multi, clip in (("cpu", False, False), (card, False, False),
                             (card, True, False), (card, False, True),
                             (card, True, True)):
        ps = [torch.nn.Parameter(torch.tensor(a, device=dev).to(
            torch.bfloat16 if i % 2 else torch.float32))
            for i, a in enumerate(inits)]
        opt = getattr(topt, cls)(
            parameters=ps, learning_rate=0.01, use_multi_tensor=multi,
            grad_clip=ClipGradByGlobalNorm(1.0) if clip else None)
        _cuda_common.reset_launch_counts()
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.tensor(g, device=dev).to(p.dtype)
            opt.step()
            opt.clear_grad()
        torch.cuda.synchronize()
        name = "fused_adam" if cls == "AdamW" else "fused_momentum"
        want = 0 if dev == "cpu" else 3 * (2 if multi else len(shapes))
        assert _cuda_common.launch_counts()[name] == want
        runs.append([t.detach().cpu() for p in ps
                     for t in [p, *opt.state[p].values()]])
    for run in runs[1:3]:
        _same_bits(run, runs[0])
    _same_bits(runs[4], runs[3])


@pytest.mark.parametrize("gran,k1_per_layer,tol", [
    ("flash_resident", 1, 2 ** -7), ("full", 2, 2 ** -7), ("mlp", 1, 2 ** -5)])
def test_recompute_step_on_card_matches_no_recompute(card, gran,
                                                     k1_per_layer, tol):
    """One step of a 2-layer bf16 O2 LLaMA (d 128: the tensor-core flash
    bodies; vocab 4096: the chunked fused CE) with `use_recompute` at
    `gran`: K1 launches once per layer, twice under "full" (the
    flash_resident policy keeps K1's o and lse), K2 once per layer, and
    the gradients are those of the same model's step without recompute
    within `tol` of each tensor's largest |value|. "full" and
    "flash_resident" repeat the first forward's kernels on the same
    inputs (one bf16 ulp of room, 2^-7). "mlp" computes the residual add
    and the post-attention norm apart, so it normalizes the bf16-rounded
    sum where the fused add+norm normalizes the f32 one: activations
    differ by a bf16 rounding (2^-8 relative) per layer and the
    difference passes on through the backward into the embedding's
    gradient, which sums every layer's; 2^-5 (8 ulps) holds that for two
    layers, as GRAD_TOL does for twenty in chip_smoke.py."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    cfg = llama_tiny_config(vocab_size=4096, hidden_size=256,
                            intermediate_size=512, num_attention_heads=2,
                            max_position_embeddings=256, use_recompute=True,
                            recompute_granularity=gran)
    torch.manual_seed(0)
    model = amp.decorate(LlamaForCausalLM(cfg, device=card), level="O2",
                         dtype="bfloat16")
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 4096, (2, 256))).to(card)
    grads, counts = [], []
    for use in (True, False):
        cfg.use_recompute = use
        for layer in model.model.layers:
            layer.recompute_mlp = use and gran == "mlp"
        _cuda_common.reset_launch_counts()
        model(ids, labels=ids).backward()
        torch.cuda.synchronize()
        counts.append(_cuda_common.launch_counts())
        grads.append({n: p.grad._data.float()
                      for n, p in model.named_parameters()})
        model.clear_gradients()
    layers = cfg.num_hidden_layers
    assert counts[0]["flash_attention_fwd"] == k1_per_layer * layers
    assert counts[1]["flash_attention_fwd"] == layers
    for c in counts:
        assert c["flash_attention_bwd_dq"] == c["flash_attention_bwd_dkv"] \
            == layers, c
    for name, g in grads[1].items():
        err = (grads[0][name] - g).abs().max() / g.abs().max()
        assert err.item() <= tol, name


@pytest.mark.parametrize("axis,n,vocab,kw", [
    ("vocab", 512, 4096, {"chunk_size": 1024}),
    ("tokens", 500, 5000, {"token_chunk": 128})])
def test_chunked_ce_on_card_matches_plain(card, axis, n, vocab, kw):
    """The chunked fused CE on the card against its unchunked plain
    version from the same bf16 inputs: the loss within 1e-4 relative (the
    same exact products, f32 sums in another order), dH and dW in bf16
    within 2^-7 of each one's largest |value| (each side rounds once to
    bf16; the token path also rounds dlogits to bf16, as the reference
    does). 500 tokens in chunks of 128 leave a ragged last chunk."""
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_linear_cross_entropy, fused_linear_cross_entropy_reference)

    rs = np.random.RandomState(4)
    h0 = _randn(rs, n, 256).to(card, torch.bfloat16)
    w0 = (_randn(rs, vocab, 256) * 0.05).to(card, torch.bfloat16)
    lab = torch.from_numpy(rs.randint(0, vocab, (n,))).to(card)
    lab[::9] = -100
    out = []
    for fn, extra in ((fused_linear_cross_entropy, dict(chunk_axis=axis,
                                                        **kw)),
                      (fused_linear_cross_entropy_reference, {})):
        h, w = h0.clone().requires_grad_(True), w0.clone().requires_grad_(
            True)
        loss = fn(h, w.T, lab, **extra)
        loss.backward()
        out.append((loss.item(), h.grad, w.grad))
    (lc, dhc, dwc), (lp, dhp, dwp) = out
    assert dhc.dtype == dwc.dtype == torch.bfloat16
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for a, b in ((dhc, dhp), (dwc, dwp)):
        a, b = a.float(), b.float()
        assert ((a - b).abs().max() / b.abs().max()).item() <= 2 ** -7


def test_ce_token_gemm_route_matches_upcast(card):
    """The token path's GEMM on a card (`aten::mm.dtype`: bf16 products,
    f32 sums and result) against the upcast route the CPU takes (the same
    exact products): within 1e-5 of the largest |value| (f32 sums in
    another order)."""
    from paddle_tpu_torch.incubate.nn.functional.fused_loss import _mm_f32

    rs = np.random.RandomState(5)
    a = _randn(rs, 256, 1024).to(card, torch.bfloat16)
    b = _randn(rs, 1024, 5000).to(card, torch.bfloat16)
    got = _mm_f32(a, b)
    want = a.float() @ b.float()
    assert got.dtype == torch.float32
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(_mm_f32(a.cpu(), b.cpu()), (a.cpu().float()
                                                   @ b.cpu().float()))


# ------------------------------------------------- to_static on the card

def _tiny_step(card, scaler=None, level="O2", dtype="bfloat16", seed=0,
               lr=1e-3, **cfg):
    """A tiny LLaMA, its AdamW and the bench's step function (auto_cast
    inside, backward, step, clear_grad; with `scaler`, the scaled form)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(seed)
    model = LlamaForCausalLM(llama_tiny_config(**cfg), device=card)
    opt = AdamW(learning_rate=lr, parameters=model.parameters())
    if level == "O2":
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype,
                                  master_weight=False)

    def step(x):
        with amp.auto_cast(enable=True, dtype=dtype, level=level):
            loss = model(x, labels=x)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss

    return model, opt, step


def test_captured_step_replays_equal_eager_steps(card):
    """A tiny bf16 O2 LLaMA step under to_static, captured at its third
    call and replayed, gives the losses of the same step run eagerly from
    the same weights, bit for bit; one graph; the launches of each replay
    equal an eager step's."""
    from paddle_tpu_torch import jit

    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 64))).to(card)
    runs = []
    for static in (False, True):
        _, _, step = _tiny_step(card)
        fn = jit.to_static(step) if static else step
        losses = []
        for i in range(7):
            _cuda_common.reset_launch_counts()
            losses.append(fn(ids).item())
            if i >= 2:
                counts = _cuda_common.launch_counts()
        runs.append((losses, counts))
        if static:
            assert len(fn._cache) == 1
            assert fn.graph_break_report()["graphs"] == 1
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]


def test_step_count_and_lr_advance_across_replays(card):
    """`_step_t` advances once a replay and a scheduler stepped between
    replays reaches the graph through `_lr_t`: the parameters after five
    replayed steps equal five eager steps bit for bit."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import AdamW, lr

    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(16, 8).astype("float32")).to(card)
    outs = []
    for static in (False, True):
        torch.manual_seed(0)
        lin = torch.nn.Linear(8, 4, device=card)
        sched = lr.StepDecay(0.1, step_size=1, gamma=0.5)
        opt = AdamW(learning_rate=sched, parameters=lin.parameters())

        def step(x):
            loss = lin(x).square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = jit.to_static(step) if static else step
        for _ in range(5):
            fn(x)
            sched.step()
        torch.cuda.synchronize()
        assert int(opt._step_t.item()) == 5
        assert opt.state_dict()["step"] == 5
        outs.append([t.detach().cpu() for t in lin.parameters()])
    _same_bits(outs[0], outs[1])


def test_fused_adam_device_scalars_repeat_plain_over_steps(card):
    """fused_adam reading its learning rate and bias corrections on the
    device, three steps (the step count advanced on the device), against
    fused_adam_reference on copies: bit for bit."""
    ps, gs, st, _ = _opt_lists(card, OPT_SIZES, torch.bfloat16,
                               torch.float32, False, 2)
    n = len(ps)
    lrs = [(1.0, 1.0) if i % 2 else (0.5, 2.0) for i in range(n)]
    runs = []
    for fn in (fused_optimizer.fused_adam,
               fused_optimizer.fused_adam_reference):
        p, m1, m2 = _clone(ps), _clone(st[0]), _clone(st[1])
        step_t = torch.zeros((), device=card)
        lr_t = torch.full((), 1e-3, device=card)
        betas = fused_optimizer.betas_tensor(0.9, 0.95, card)
        for _ in range(3):
            step_t.add_(1.0)
            bc = fused_optimizer.bias_corrections(betas, step_t)
            fn(p, _clone(gs), m1, m2, None, None, lrs, [0.1] * n,
               beta1=0.9, beta2=0.95, epsilon=1e-8, decoupled=True,
               lr=lr_t, bc=bc)
            lr_t.mul_(0.5)
        torch.cuda.synchronize()
        runs.append(p + m1 + m2)
    _same_bits(runs[0], runs[1])


def test_sync_inside_to_static_is_a_graph_break_on_card(card):
    """A host read inside the function is found at discovery on the card
    too: the third call warns "graph break", captures nothing and runs
    eagerly; with full_graph=True it raises."""
    import warnings

    from paddle_tpu_torch import jit

    def f(x):
        if float(x.sum()) > 0:
            return x * 2
        return x * 3

    x = torch.ones(3, device=card)
    g = jit.to_static(f)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        outs = [g(x) for _ in range(4)]
    assert g._segmented and not g._cache or all(
        s.captured is None for s in g._cache.values())
    assert any("graph break" in str(m.message) for m in w)
    assert all(torch.equal(o, 2 * x) for o in outs)
    h = jit.to_static(f, full_graph=True)
    h(x)
    h(x)
    with pytest.raises(RuntimeError, match="full_graph=True"):
        h(x)


def test_grad_scaler_masked_branch_inside_graph(card):
    """In a captured step an overflowing gradient takes the reference's
    traced branch: the update runs on zeroed gradients (the moments of the
    earlier steps still move the weights) and the scale halves; eagerly
    the step is skipped (the weights stay). Both scalers' state dicts
    agree."""
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.optimizer import AdamW

    x = torch.ones(4, 8, device=card)
    results = []
    for static in (False, True):
        torch.manual_seed(0)
        lin = torch.nn.Linear(8, 4, device=card)
        opt = AdamW(learning_rate=0.1, weight_decay=0.0,
                    parameters=lin.parameters())
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15, device=card)
        bomb = torch.zeros((), device=card)

        def step(x):
            loss = lin(x).sum() * (1.0 + bomb)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss

        fn = jit.to_static(step) if static else step
        for _ in range(3):                     # warm-up, discovery, capture
            fn(x)
        w_before = lin.weight.detach().clone()
        bomb.fill_(float("inf"))
        fn(x)
        torch.cuda.synchronize()
        results.append((torch.equal(lin.weight, w_before),
                        scaler.state_dict()["scale"].item()))
    assert results[0] == (True, 2.0 ** 14)
    assert results[1] == (False, 2.0 ** 14)


def test_dropped_compiled_functions_leave_no_device_memory(card):
    """A CompiledFunction's graphs, pool, static inputs and outputs go
    with it: building and dropping captured step functions brings the
    allocator back to where it started."""
    import gc

    from paddle_tpu_torch import jit

    x = torch.randn(64, 256, device=card)
    w = torch.randn(256, 256, device=card)

    def f(x):
        return torch.tanh(x @ w) @ w

    f(x)
    torch.cuda.synchronize()
    gc.collect()
    start = torch.cuda.memory_allocated()
    for _ in range(3):
        g = jit.to_static(f)
        for _ in range(4):
            g(x)
        torch.cuda.synchronize()
        del g
        gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == start


@pytest.mark.parametrize("arch", ["llama", "gpt", "bert"])
def test_float16_o2_steps_run_on_card(card, arch):
    """F7: `amp.decorate(level="O2", dtype="float16")` models train on the
    card: two AdamW steps of a tiny LLaMA, GPT and BERT with float16
    parameters, the attention through the flash kernels in f16 (K1 and
    both K2 kernels once per layer and step), finite losses."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (
        BertConfig, BertForSequenceClassification, GPTConfig,
        GPTForCausalLM, LlamaForCausalLM, llama_tiny_config)

    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 256, (2, 64))).to(card)
    labels = ids
    if arch == "llama":
        model = LlamaForCausalLM(llama_tiny_config(), device=card)
    elif arch == "gpt":
        model = GPTForCausalLM(GPTConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64), device=card)
    else:
        model = BertForSequenceClassification(BertConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64), device=card)
        labels = torch.from_numpy(rs.randint(0, 2, (2,))).to(card)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    assert torch.float16 in {p.dtype for p in model.parameters()}
    _cuda_common.reset_launch_counts()
    losses = []
    for _ in range(2):
        with amp.auto_cast(enable=True, dtype="float16", level="O2"):
            loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    torch.cuda.synchronize()
    counts = _cuda_common.launch_counts()
    assert all(np.isfinite(losses)), losses
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == 2 * 2, counts


# ------------------------------------------------------- the Tensor surface
# The Tensor API on the card: each row of the port's op table on CUDA
# Tensors against the same row on the CPU (fp32 forward and gradients at
# the row's tolerances, bf16 forward against fp32 at 5e-2), every output
# on the card; and one LLaMA decoder layer written on the Tensor surface
# at a small width: its launches per step and its gradients against
# `LlamaDecoderLayer.forward` on torch tensors (2^-4 of each tensor's
# largest |value|, as chip_smoke.py's DYGRAPH).

def _op_rows():
    from paddle_tpu_torch.ops import op_table

    op_table.ensure_populated()
    return op_table.OPS


@pytest.fixture
def on_card(card):
    from paddle_tpu_torch.core import device as port_device

    prev = port_device._current
    yield card
    port_device._current = prev


def _row_on(spec, arrays, place, bf16=False, grads=False):
    import paddle_tpu_torch as pt

    pt.set_device(place)
    skip = set(spec.int_inputs) | set(spec.no_grad_inputs)
    ts = []
    for i, a in enumerate(arrays):
        t = pt.to_tensor(a)
        if bf16 and i not in spec.int_inputs:
            t = t.astype("bfloat16")
        if grads and i not in skip:
            t.stop_gradient = False
        ts.append(t)
    out = spec.fn(*ts, **spec.kwargs)
    out = out[0] if isinstance(out, (list, tuple)) else out
    if not grads:
        return out, None
    out.sum().backward()
    return out, [ts[i].grad for i in range(len(ts)) if i not in skip]


@pytest.mark.parametrize("name", sorted(_op_rows()))
def test_tensor_op_table_row_on_card_matches_cpu(on_card, name):
    spec = _op_rows()[name]
    arrays = spec.sample_inputs(seed=0)
    out, _ = _row_on(spec, arrays, "gpu")
    assert out._data.device.type == "cuda"
    cpu, _ = _row_on(spec, arrays, "cpu")
    np.testing.assert_allclose(out.numpy().astype("float64"),
                               cpu.numpy().astype("float64"),
                               rtol=spec.rtol, atol=spec.atol,
                               equal_nan=True)
    if spec.bf16:
        a2 = spec.sample_inputs(seed=2)
        o32, _ = _row_on(spec, a2, "gpu")
        ob, _ = _row_on(spec, a2, "gpu", bf16=True)
        assert ob._data.device.type == "cuda"
        np.testing.assert_allclose(ob.numpy().astype("float64"),
                                   o32.numpy().astype("float64"),
                                   rtol=5e-2, atol=5e-2)
    if spec.diff:
        a1 = spec.sample_inputs(seed=1)
        _, gg = _row_on(spec, a1, "gpu", grads=True)
        _, gc_ = _row_on(spec, a1, "cpu", grads=True)
        for g, c in zip(gg, gc_):
            assert (g is None) == (c is None)
            if g is not None:
                assert g._data.device.type == "cuda"
                np.testing.assert_allclose(g.numpy(), c.numpy(),
                                           rtol=spec.rtol, atol=spec.atol)


def test_dygraph_layer_on_card_launches_and_grads(on_card):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

    pt.set_device("gpu")
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=1, num_attention_heads=2,
                      max_position_embeddings=128)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    layer = model.model.layers[0]
    cos, sin = model.rope_tables()
    a_, m_ = layer.self_attn, layer.mlp
    mods = [layer.input_layernorm, a_.q_proj, a_.k_proj, a_.v_proj,
            a_.o_proj, layer.post_attention_layernorm, m_.gate_proj,
            m_.up_proj, m_.down_proj]
    tw = [w.weight._data.detach() for w in mods]    # [in, out] already
    params = [pt.to_tensor(w.contiguous(), stop_gradient=False) for w in tw]
    x = torch.randn(2, 64, 256, device="cuda").to(torch.bfloat16)

    def loss_of(xt):
        n1, wq, wk, wv, wo, n2, wg, wu, wd = params
        b, s, h = xt.shape
        y = PF.rms_norm(xt, n1, cfg.rms_norm_eps)
        q, k, v = (pt.matmul(y, w).reshape([b, s, 2, 128])
                   for w in (wq, wk, wv))
        q, k = PF.rotary_position_embedding(q, k, cos[None, :s, None, :],
                                            sin[None, :s, None, :])
        o = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        y2, x2 = PF.fused_add_rms_norm(
            pt.matmul(o.reshape([b, s, 256]), wo), xt, n2, cfg.rms_norm_eps)
        out = x2 + pt.matmul(PF.swiglu(pt.matmul(y2, wg),
                                       pt.matmul(y2, wu)), wd)
        return (out.astype("float32") ** 2).mean()

    opt = AdamW(learning_rate=1e-3, parameters=params)
    _cuda_common.reset_launch_counts()
    loss = loss_of(pt.Tensor._wrap(x))
    loss.backward()
    grads = [p.grad._data.clone() for p in params]
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    got = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    assert got == {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                   "flash_attention_bwd_dkv": 1, "fused_rms_norm_fwd": 2,
                   "fused_rms_norm_bwd": 2, "rope_qk": 2, "swiglu_fwd": 1,
                   "swiglu_bwd": 1, "fused_adam": 9}, got
    ref = (layer(x, cos, sin).float() ** 2).mean()
    ref.backward()
    for g, mod in zip(grads, mods):
        rg = mod.weight.grad._data
        top = rg.float().abs().max().item()
        assert (g.float() - rg.float()).abs().max().item() <= 2 ** -4 * top
    assert abs(loss.item() - ref.item()) <= 1e-2 * abs(ref.item())


# The nn half of the Tensor surface on the card: each layer or functional
# that the reference sends to a Pallas kernel launches the port's kernel
# (counted) and agrees with the same layer on the CPU, where the kernels'
# plain versions run (f32: 1e-4 of each output's largest |value|; the
# gradients of a weighted sum 1e-3 of theirs; the attention's key bias,
# whose exact gradient is 0, is rounding on both sides and held to its key
# weight's scale, as chip_smoke.py's gradient checks hold it).

def _nn_case(name):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as pnn
    import paddle_tpu_torch.nn.functional as PF

    rs = np.random.RandomState(0)
    x = rs.randn(2, 64, 32).astype("float32")
    if name == "LayerNorm":
        return (lambda: pnn.LayerNorm(32), lambda m, t: m(t), [x],
                {"fused_layer_norm_fwd": 1, "fused_layer_norm_bwd": 1})
    if name == "RMSNorm":
        return (lambda: pnn.RMSNorm(32), lambda m, t: m(t), [x],
                {"fused_rms_norm_fwd": 1, "fused_rms_norm_bwd": 1})
    if name == "MultiHeadAttention":
        return (lambda: pnn.MultiHeadAttention(32, 4), lambda m, t: m(t),
                [x], {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                      "flash_attention_bwd_dkv": 1})
    if name == "swiglu":
        return (lambda: pnn.Linear(32, 32),
                lambda m, t: PF.swiglu(m(t), t), [x],
                {"swiglu_fwd": 1, "swiglu_bwd": 1})
    if name == "fused_dropout_add":
        return (lambda: pnn.Linear(32, 32),
                lambda m, t: PF.fused_dropout_add(m(t), t, p=0.0) +
                PF.fused_dropout_add(m(t), t, p=0.5, training=False), [x],
                {})
    if name == "fused_dropout_add_train":
        def call(m, t):
            pt.seed(5)
            return PF.fused_dropout_add(m(t), t, p=0.25)
        return (lambda: pnn.Linear(32, 32), call, [x],
                {"dropout_add_fwd": 1, "dropout_add_bwd": 1})
    if name == "rotary_position_embedding":
        cs = rs.randn(1, 64, 1, 8).astype("float32")
        return (lambda: pnn.Linear(32, 32),
                lambda m, t, c: PF.rotary_position_embedding(
                    m(t).reshape([2, 64, 4, 8]), t.reshape([2, 64, 4, 8]),
                    c, c * 0.5)[0], [x, cs], {"rope_qk": 2})
    raise KeyError(name)


def _nn_run(build, call, arrays, place, weights=None):
    import paddle_tpu_torch as pt

    pt.set_device(place)
    pt.seed(0)
    layer = build()
    if weights is not None:
        layer.set_state_dict(weights)
    ts = [pt.to_tensor(a, stop_gradient=False) for a in arrays]
    out = call(layer, *ts)
    cot = np.random.RandomState(7).randn(*out.shape).astype("float32")
    (out * pt.to_tensor(cot)).sum().backward()
    grads = {"input": ts[0].grad.numpy()}
    grads.update({n: p.grad.numpy() for n, p in layer.named_parameters()})
    return layer, out.numpy(), grads


@pytest.mark.parametrize("name", [
    "LayerNorm", "RMSNorm", "MultiHeadAttention", "swiglu",
    "fused_dropout_add", "fused_dropout_add_train",
    "rotary_position_embedding"])
def test_nn_layers_launch_their_kernels(on_card, name):
    build, call, arrays, want = _nn_case(name)
    _cuda_common.reset_launch_counts()
    layer, out, grads = _nn_run(build, call, arrays, "gpu")
    torch.cuda.synchronize()
    got = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    assert got == want, got
    weights = {k: v.numpy() for k, v in layer.state_dict().items()}
    if name == "fused_dropout_add_train":      # the CPU draws other masks
        return
    _, cout, cgrads = _nn_run(build, call, arrays, "cpu", weights)
    top = np.abs(cout).max()
    assert np.abs(out - cout).max() <= 1e-4 * top
    for n, c in cgrads.items():
        scale = cgrads[n[:-4] + "weight"] if n.endswith("k_proj.bias") else c
        assert np.abs(grads[n] - c).max() <= 1e-3 * np.abs(scale).max(), n


def test_layer_to_cuda_keeps_parameters(on_card):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as pnn

    pt.set_device("cpu")
    net = pnn.Sequential(pnn.Linear(4, 8), pnn.BatchNorm1D(8))
    leaves = [p._data for p in net.parameters()]
    net.to("gpu")
    opt = pt.optimizer.AdamW(parameters=net.parameters())
    assert all(isinstance(p, pt.Parameter) for p in net.parameters())
    assert all(p._data is leaf and p._data.device.type == "cuda"
               for p, leaf in zip(net.parameters(), leaves))
    assert all(b._data.device.type == "cuda" for b in net.buffers())
    pt.set_device("gpu")
    loss = net(pt.to_tensor(np.ones((3, 4), "float32"))).sum()
    loss.backward()
    before = net[0].weight.numpy().copy()
    opt.step()
    assert not np.array_equal(net[0].weight.numpy(), before)


# K1's and K9's rounding residual of O (o_res), on every route, and K2
# with the delta it gives (test_torch_flash_delta.py holds the plain
# versions on the CPU). o itself is unchanged and o_res lies within half a
# unit in the last place of o (zero in f32). The CUDA-core bodies' f32 O
# is P V in f32, so o + o_res meets the plain f32 O within 2^-14 of its
# largest value; the tensor-core body multiplies P rounded to bf16 by V,
# so there o + o_res lies nearer the plain f32 O than o on average, and
# on values spread 2^-6 around a common row (where the rounding of o
# dominates) within an eighth of o's mean distance. On nearly equal values
# (spread 1/4) the differentiable op's dQ and dK stay within 2^-5 of each
# gradient's largest value of an f64 truth and nearer than the delta of
# the rounded O, and its gradients are K2's plain version's with the
# residual's delta within one bf16 ulp.

_ULP = {torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11}


def _check_residual(o, o_same, res, o32, tensor_cores):
    assert res.dtype == o.dtype and res.shape == o.shape
    assert torch.equal(o, o_same)
    if o.dtype == torch.float32:
        assert not res.any()
        return
    # (plus f16's subnormal spacing, where o is tiny)
    assert (res.float().abs()
            <= _ULP[o.dtype] * o.float().abs() + 2 ** -24).all()
    exact = (o.float() + res.float() - o32).abs()
    rounded = (o.float() - o32).abs()
    if tensor_cores:
        assert exact.mean() < rounded.mean(), (exact.mean(), rounded.mean())
    else:
        assert exact.max() <= 2 ** -14 * o32.abs().max(), exact.max()


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,causal,varlen", [
    (1, 16, 16, 500, 128, torch.bfloat16, True, False),
    (2, 8, 2, 77, 64, torch.bfloat16, False, False),
    (2, 4, 4, 130, 40, torch.bfloat16, True, True),
    (1, 4, 4, 200, 256, torch.bfloat16, True, False),
    (2, 4, 2, 130, 64, torch.float16, True, True),
    (1, 4, 4, 96, 32, torch.float32, False, False)],
    ids=["tc", "tc-gqa-full", "tc-varlen-pad", "core-d256", "core-f16",
         "core-f32"])
def test_flash_residual_matches_plain(card, b, hq, hkv, s, d, dtype, causal,
                                      varlen):
    from paddle_tpu_torch.ops.flash_attention import _tensor_core_route
    rs = np.random.RandomState(0)
    q = _randn(rs, b, hq, s, d).to(card, dtype)
    k, v = (_randn(rs, b, hkv, s, d).to(card, dtype) for _ in range(2))
    lens = torch.tensor([s, s // 3], dtype=torch.int32, device=card) \
        if varlen else None
    o, lse, res = flash_attention_fwd(q, k, v, causal, lens, residual=True)
    o32, _ = flash_attention_reference(q.float(), k.float(), v.float(),
                                       causal, lens)
    _check_residual(o, flash_attention_fwd(q, k, v, causal, lens)[0], res,
                    o32, _tensor_core_route("flash_attention_fwd", dtype,
                                            varlen, d))


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (64, torch.float16)],
                         ids=["tc", "core-d256", "core-f16"])
def test_flashmask_residual_matches_plain(card, d, dtype):
    from paddle_tpu_torch.ops.flashmask import (
        flashmask_attention_reference, flashmask_fwd, tensor_core_route)
    rs = np.random.RandomState(5)
    q, k, v = (_randn(rs, 1, 4, 300, d).to(card, dtype) for _ in range(3))
    start = torch.from_numpy(rs.randint(0, 301, (1, 4, 300)).astype(
        np.int32)).to(card)
    o, lse, res = flashmask_fwd(q, k, v, start, True, residual=True)
    o32, _ = flashmask_attention_reference(q.float(), k.float(), v.float(),
                                           start, True)
    _check_residual(o, flashmask_fwd(q, k, v, start, True)[0], res, o32,
                    tensor_core_route("flashmask_fwd", dtype, d))


def test_flash_residual_on_near_equal_values(card):
    rs = np.random.RandomState(2)
    q, k = (_randn(rs, 2, 8, 256, 64).to(card, torch.bfloat16)
            for _ in range(2))
    v = (_randn(rs, 2, 8, 1, 64) + 2 ** -6 * _randn(rs, 2, 8, 256, 64)).to(
        card, torch.bfloat16)
    o, _, res = flash_attention_fwd(q, k, v, True, residual=True)
    o32, _ = flash_attention_reference(q.float(), k.float(), v.float(), True)
    exact = (o.float() + res.float() - o32).abs().mean().item()
    rounded = (o.float() - o32).abs().mean().item()
    assert exact <= rounded / 8, (exact, rounded)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_exact_delta_on_near_equal_values(card, causal):
    rs = np.random.RandomState(1)
    q, k, do = (_randn(rs, 2, 8, 256, 64).to(card, torch.bfloat16)
                for _ in range(3))
    v = (_randn(rs, 2, 8, 1, 64) + 0.25 * _randn(rs, 2, 8, 256, 64)).to(
        card, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = flash_attention(*leaves, causal)
    o.backward(do)
    o_, lse, res = flash_attention_fwd(q, k, v, causal, residual=True)
    assert torch.equal(o.detach(), o_)
    want = flash_attention_bwd_reference(q, k, v, o_, lse, do, causal,
                                         o_res=res)
    for t, w in zip(leaves, want):
        err = (t.grad.float() - w.float()).abs().max().item()
        assert err <= 2 ** -7 * w.float().abs().max().item(), err
    rounded = flash_attention_bwd(q, k, v, o_, lse, do, causal)
    truth = [t.double().requires_grad_() for t in (q, k, v)]
    o64, _ = flash_attention_reference(*truth, causal)
    (o64 * do.double()).sum().backward()
    for i in (0, 1):
        top = truth[i].grad.abs().max().item()
        err = (leaves[i].grad.double() - truth[i].grad).abs().max().item()
        old = (rounded[i].double() - truth[i].grad).abs().max().item()
        assert err <= 2 ** -5 * top and err < old, (i, err / top, old / top)


# The long tail on the card: incubate.nn.functional's kernel paths (K3,
# K3-LN, K4, K5, K6), the models as nn.Layers, and signal.stft.
def _incubate_cases(dev, dtype):
    from paddle_tpu_torch.incubate.nn import functional as IF

    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, device=dev, generator=g, dtype=dt)

    ang = torch.arange(64, device=dev, dtype=torch.float32)[:, None] \
        * torch.linspace(0.01, 1.0, 16, device=dev)[None]
    ang = torch.cat([ang, ang], -1)[None, :, None, :]
    return {
        "fused_rms_norm": (
            lambda x, w: IF.fused_rms_norm(x, w, epsilon=1e-6)[:1],
            (rnd(66, 256), rnd(256)), ("fused_rms_norm_fwd",
                                       "fused_rms_norm_bwd")),
        "fused_rms_norm_residual": (
            lambda x, r, w: IF.fused_rms_norm(x, w, epsilon=1e-6,
                                              residual=r),
            (rnd(66, 256), rnd(66, 256), rnd(256)),
            ("fused_rms_norm_fwd", "fused_rms_norm_bwd")),
        "fused_layer_norm": (
            lambda x, w, b: IF.fused_layer_norm(x, w, b)[:1],
            (rnd(66, 96), rnd(96, dt=torch.float32),
             rnd(96, dt=torch.float32)),
            ("fused_layer_norm_fwd", "fused_layer_norm_bwd")),
        "fused_layer_norm_residual": (
            lambda x, r, w, b: IF.fused_layer_norm(x, w, b, residual=r),
            (rnd(66, 96), rnd(66, 96), rnd(96), rnd(96)),
            ("fused_layer_norm_fwd", "fused_layer_norm_bwd")),
        "fused_rotary_position_embedding": (
            lambda q, k: IF.fused_rotary_position_embedding(
                q, k, sin=ang.sin().to(q.device, dtype),
                cos=ang.cos().to(q.device, dtype)),
            (rnd(2, 64, 4, 32), rnd(2, 64, 4, 32)), ("rope_qk", "rope_qk")),
        "swiglu": (lambda a, b: (IF.swiglu(a, b),),
                   (rnd(66, 200), rnd(66, 200)),
                   ("swiglu_fwd", "swiglu_bwd")),
    }


def _run_incubate(fn, inputs, douts=None):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    if douts is None:
        g = torch.Generator(device=outs[0].device).manual_seed(5)
        douts = [torch.randn(o.shape, generator=g, device=o.device,
                             dtype=o.dtype) for o in outs]
    torch.autograd.backward(outs, douts)
    return [o.detach() for o in outs], [t.grad for t in leaves], douts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(_incubate_cases("cpu",
                                                        torch.float32)))
def test_incubate_kernel_paths_launch_once_and_match_plain(card, name,
                                                          dtype):
    """Each kernel path of incubate.nn.functional launches its forward
    kernel once in the forward and its backward kernel once in the
    backward, and nothing else; its outputs and gradients equal the same
    call's on CPU copies (the kernels' plain versions) within a tolerance
    of each tensor's largest |value| keyed by the inputs' dtype, as
    chip_smoke.py's INCUBATE_FUSED keys it: 1e-5 for f32 inputs (1e-4
    for a weight's gradient, a sum over rows), 2^-7 for bf16 inputs,
    whose f32 results carry bf16 precision (`fused_layer_norm` writes
    its norm in x's dtype before the f32 weight's promotion, so a sum
    that lands the other side of a rounding boundary moves it by one
    bf16 ulp)."""
    fn, inputs, (fwd, bwd) = _incubate_cases(card, dtype)[name]
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    torch.cuda.synchronize()
    _cuda_common.reset_launch_counts()
    outs = fn(*leaves)
    torch.cuda.synchronize()
    got_fwd = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    g = torch.Generator(device=card).manual_seed(5)
    douts = [torch.randn(o.shape, generator=g, device=card, dtype=o.dtype)
             for o in outs]
    _cuda_common.reset_launch_counts()
    torch.autograd.backward(outs, douts)
    torch.cuda.synchronize()
    got_bwd = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    assert got_fwd == {fwd: 1} and got_bwd == {bwd: 1}, (got_fwd, got_bwd)
    pouts, pgrads, _ = _run_incubate(fn, [t.cpu() for t in inputs],
                                     [d.cpu() for d in douts])
    got = [o.detach() for o in outs] + [t.grad for t in leaves]
    for i, (a, w) in enumerate(zip(got, pouts + pgrads)):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        rel = ((a.cpu().float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        tol = 2 ** -7 if dtype == torch.bfloat16 else (
            1e-4 if a.dim() == 1 else 1e-5)
        assert rel <= tol, (i, rel)


def test_incubate_dropout_add_launches_k6_once_and_matches_composition(
        card):
    """fused_dropout_add (K6) against the flag-off composition on the card
    with the same seed (one mask): one launch each way, and the same
    values within 2^-7 of the largest |value| in bf16."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.incubate.nn import functional as IF

    g = torch.Generator(device=card).manual_seed(2)
    x, y = (torch.randn(130, 96, device=card, generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    dout = torch.randn(130, 96, device=card, generator=g,
                       dtype=torch.bfloat16)
    res = []
    for fused in (True, False):
        set_flags({"FLAGS_pallas_fused_ops": fused})
        try:
            xl, yl = (t.clone().requires_grad_() for t in (x, y))
            _cuda_common.reset_launch_counts()
            torch.manual_seed(9)
            out = IF.fused_dropout_add(xl, yl, p=0.3)
            out.backward(dout)
            torch.cuda.synchronize()
            res.append(([out.detach(), xl.grad, yl.grad],
                        {n: c for n, c in
                         _cuda_common.launch_counts().items() if c}))
        finally:
            set_flags({"FLAGS_pallas_fused_ops": True})
    assert res[0][1] == {"dropout_add_fwd": 1, "dropout_add_bwd": 1}
    assert res[1][1] == {}
    for a, w in zip(res[0][0], res[1][0]):
        assert ((a.float() - w.float()).abs().max()
                / w.float().abs().max()).item() <= 2 ** -7


@pytest.mark.parametrize("arch", ["llama", "gpt", "bert"])
def test_layer_models_on_card_match_cpu(card, arch):
    """A tiny model of each kind as an nn.Layer on the card: its
    state_dict keys and shapes are the CPU model's (the reference's
    naming), its parameters the Tensor API's; carried over with
    set_state_dict, its f32 loss and gradients equal the CPU's within
    1e-4 of each tensor's largest |value|, through the kernels (K1, and
    K3-K5 or K3-LN, each at least once; BERT without dropout, so that
    both sides draw no mask)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models import (
        BertConfig, BertForSequenceClassification, GPTConfig,
        GPTForCausalLM, LlamaForCausalLM, llama_tiny_config)
    from paddle_tpu_torch.text.models.convert import state_dict_shapes

    rs = np.random.RandomState(1)
    if arch == "llama":
        cfg = llama_tiny_config()
        build = lambda d: LlamaForCausalLM(cfg, device=d)    # noqa: E731
        labels = ids = torch.from_numpy(rs.randint(0, 256, (2, 40)))
        kernels = ("flash_attention_fwd", "fused_rms_norm_fwd", "rope_qk",
                   "swiglu_bwd")
    elif arch == "gpt":
        cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=64)
        build = lambda d: GPTForCausalLM(cfg, device=d)      # noqa: E731
        labels = ids = torch.from_numpy(rs.randint(0, 256, (2, 40)))
        kernels = ("flash_attention_fwd", "fused_layer_norm_bwd")
    else:
        cfg = BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         hidden_dropout_prob=0.0)
        build = lambda d: BertForSequenceClassification(  # noqa: E731
            cfg, device=d)
        ids = torch.from_numpy(rs.randint(0, 256, (2, 40)))
        labels = torch.from_numpy(rs.randint(0, 2, (2,)))
        kernels = ("flash_attention_fwd", "fused_layer_norm_fwd")
    torch.manual_seed(0)
    cpu, gpu = build("cpu"), build(card)
    assert [(k, v.shape) for k, v in gpu.state_dict().items()] \
        == state_dict_shapes(cfg)
    assert all(isinstance(p, pt.Parameter) for p in gpu.parameters())
    gpu.set_state_dict(cpu.state_dict())
    grads = []
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        _cuda_common.reset_launch_counts()
        torch.manual_seed(3)
        loss = model(ids.to(dev), labels=labels.to(dev))
        loss.backward()
        grads.append((loss.item(), {n: p.grad._data.cpu() for n, p in
                                    model.named_parameters()
                                    if p.grad is not None}))
        counts = _cuda_common.launch_counts()
        if dev == "cpu":
            assert not any(counts.values())
        else:
            assert all(counts[k] >= 1 for k in kernels), counts
    (lc, gc), (lg, gg) = grads
    assert abs(lc - lg) <= 1e-4 * abs(lc) and set(gc) == set(gg)
    for n, w in gc.items():
        # BERT's key bias gets no gradient in exact arithmetic (a softmax
        # ignores a shift common to its keys): rounding on both sides,
        # held to the key weight's scale
        scale = gc[n[:-4] + "weight"] if n.endswith("key.bias") else w
        assert ((gg[n] - w).abs().max() / scale.abs().max()).item() \
            <= 1e-4, n


def test_signal_stft_on_card_matches_cpu(card):
    """signal.stft / istft on the card: the spectrum equals the CPU's
    within 1e-4 of its largest |value|, and the round trip gives the
    signal back within 1e-4 (its length a multiple of the hop, so every
    sample lies under a frame)."""
    from paddle_tpu_torch import signal

    x = torch.from_numpy(np.random.RandomState(0).randn(3, 4096)
                         .astype("float32"))
    win = torch.from_numpy(np.hanning(256).astype("float32"))
    spec = signal.stft(x.to(card), 256, 64, window=win.to(card))
    want = signal.stft(x, 256, 64, window=win)
    assert spec.is_cuda and spec.dtype == torch.complex64
    assert ((spec.cpu() - want).abs().max() / want.abs().max()).item() \
        <= 1e-4
    back = signal.istft(spec, 256, 64, window=win.to(card), length=4096)
    assert ((back.cpu() - x).abs().max() / x.abs().max()).item() <= 1e-4


# ------------------------------------- quantization API, static, verify

def test_quant_linear_function_forward_and_backward(card):
    """`weight_only_linear`'s per-channel int4 route on the card: one K8
    launch a forward, and the autograd Function's dx = (dy * s) @ qᵀ,
    both against the plain composition (f32 1e-5 and bf16 2^-7 of the
    largest |value|)."""
    from paddle_tpu_torch.ops.quantized import quant_linear

    rs = np.random.RandomState(21)
    packed, scale = quantize_int4(_randn(rs, 256, 128).to(card))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        x = _randn(rs, 2, 9, 256).to(card, dtype).requires_grad_()
        xr = x.detach().clone().requires_grad_()
        dy = _randn(rs, 2, 9, 128).to(card, dtype)
        before = _cuda_common.launch_counts()["quant_matmul"]
        y = quant_linear(x, packed, scale)
        assert _cuda_common.launch_counts()["quant_matmul"] == before + 1
        want = quant_linear(xr, packed, scale,
                            int4_matmul=quant_matmul_reference)
        y.backward(dy)
        q = int4_unpack(packed, 256, axis=0).to(dtype)
        dx = (dy * scale.to(dtype)) @ q.T
        for got, ref in ((y, want), (x.grad, dx)):
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m", [1, 9, 17, 40])
def test_int8_matmul_padded_is_exact(card, m):
    """`torch._int_mm` (cuBLASLt) behind llm_int8_linear and full-int8
    QuantizedLinear, at M, K, N it pads up (M > 16, K and N multiples of
    8): int32 sums equal a CPU int64 product at K = 5504."""
    from paddle_tpu_torch.ops.quantized import int8_matmul

    rs = np.random.RandomState(m)
    a = rs.randint(-127, 128, (m, 5501)).astype(np.int8)
    b = rs.randint(-127, 128, (5501, 37)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a).to(card),
                      torch.from_numpy(b).to(card))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, 37)
    np.testing.assert_array_equal(
        got.cpu().numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("weight_quant", ["none", "int4"])
def test_static_generate_replays_equal_its_eager_body(card, weight_quant):
    """The static engine's decode step captured as one CUDA graph and
    replayed gives the tokens of the same step run eagerly (bf16, GQA, a
    prompt bucket of 16), and the f32 CPU run's in f32; a second generate
    of the key replays without a capture."""
    from paddle_tpu_torch.text import generation
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    ids = np.random.RandomState(3).randint(0, 256, (3, 11))
    for dtype in (torch.float32, torch.bfloat16):
        gpu = LlamaForCausalLM(cfg, device=card, dtype=dtype)
        if dtype == torch.float32:
            cpu = LlamaForCausalLM(cfg, device="cpu")
            gpu.set_state_dict(cpu.state_dict())
        args = (ids, 13, False, 1.0, 0, 1.0, None, 0, weight_quant)
        graph = generation._generate_static(gpu, *args)
        assert generation.static_program_stats(gpu)["graphs"] == 1
        again = generation._generate_static(gpu, *args)
        assert generation.static_program_stats(gpu)["graphs"] == 1
        # the same prefill and steps, eagerly, on a program of their own
        _, progs = generation._static_entry(gpu, weight_quant)
        (prog,) = progs.values()
        total, g = prog.k.shape[2], prog.toks.shape[1]
        own = generation._StaticProgram(prog.spec, prog.params, 3, total, g,
                                        (False, 1.0, 0, 1.0), -1, card)
        ids_p = np.zeros((3, total - g), np.int64)
        ids_p[:, :11] = ids
        own.prefill(torch.from_numpy(ids_p).to(card), 11)
        for _ in range(g - 1):
            own.step()
        assert own.graph is None
        eager = own.toks.cpu().numpy()[:, :13]
        np.testing.assert_array_equal(graph, eager)
        np.testing.assert_array_equal(again, eager)
        if dtype == torch.float32:
            np.testing.assert_array_equal(
                graph, generation._generate_static(cpu, *args))


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "int4"])
def test_verify_program_replays_equal_its_eager_body(card, kv_cache_dtype):
    """The speculating engine's verify window ("serving.spec_verify", one
    graph per (bucket, k)) replayed gives the eager engine's tokens and
    window counts at int8 and int4 KV; at int8 both give the plain
    engine's (the reference's contract). An int4 cache's blocks are
    requantized over whatever positions a window wrote, so a speculating
    run's int4 codes, and then near-tie tokens, may differ from a plain
    run's."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    gpu = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                           device=card)
    rs = np.random.RandomState(0)
    prompts = [np.tile(rs.randint(0, 256, (4,)), 5) for _ in range(3)]

    def run(spec, capture):
        eng = ServingEngine(gpu, max_slots=2, kv_block_size=8, device=card,
                            kv_cache_dtype=kv_cache_dtype, spec_decode=spec)
        eng._capture = capture
        rids = [eng.add_request(p, max_new_tokens=20) for p in prompts]
        out = eng.run()
        return eng, [out[r].tolist() for r in rids]

    graph, got = run("ngram", True)
    eager, want = run("ngram", False)
    assert got == want
    if kv_cache_dtype == "int8":
        assert got == run(None, True)[1]
    assert graph.spec_stats() == eager.spec_stats()
    assert graph.spec_stats()["windows"] > 0
    assert graph._graph_stats()["graphs_captured"]["serving.spec_verify"] \
        >= 1


# -------------------------------------------------- GPT serving's shapes

@pytest.mark.parametrize("fmt", ["model", "int8", "int4"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_paged_decode_at_gpt_medium_shape(card, fmt, dtype, tol):
    """K7 / K7q at GPT-3 medium's decode: 8 sequences x 16 heads x D64,
    group 1 (every head its own kv head), 16-token blocks over a
    1024-token table; one launch of the format's entry, within the
    decode tests' tolerances of the plain version."""
    rs = np.random.RandomState(64)
    args = _decode_inputs(card, rs, 8, 16, 16, 64, 16, 64, 600, dtype, fmt)
    kw = {"kv_int4": fmt == "int4"}
    _cuda_common.reset_launch_counts()
    out = paged_decode_attention(*args[:5], *args[5:], **kw)
    ref = paged_decode_attention_reference(*args[:5], *args[5:], **kw)
    torch.cuda.synchronize()
    assert _launched() == {KERNEL_NAMES[fmt]: 1}
    assert out.dtype == dtype and out.shape == (8, 16, 64)
    assert (out.float() - ref.float()).abs().max().item() < tol
    assert torch.equal(out, paged_decode_attention(*args[:5], *args[5:],
                                                   **kw))


@pytest.mark.parametrize("k,n", [(1024, 3072), (1024, 1024), (1024, 4096),
                                 (4096, 1024)],
                         ids=["qkv", "o", "fc_in", "fc_out"])
@pytest.mark.parametrize("m", [8, 512])
def test_quant_matmul_at_gpt_medium_shapes(card, m, k, n):
    """K8 at GPT-3 medium's four int4 layer matmuls, bf16, at decode (M
    8) and prefill (M 512): one launch a call, two calls bit for bit,
    within 2^-7 of the largest output of the plain version."""
    rs = np.random.RandomState(k + n + m)
    x = _randn(rs, m, k).to(card, torch.bfloat16)
    packed, scale = quantize_int4(_randn(rs, k, n) * 0.02)
    packed, scale = packed.to(card), scale.to(card)
    _cuda_common.reset_launch_counts()
    out = quant_matmul_raw(x, packed, scale, k)
    again = quant_matmul_raw(x, packed, scale, k)
    ref = quant_matmul_reference(x, packed, scale, k)
    torch.cuda.synchronize()
    assert _launched() == {"quant_matmul": 2}
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (m, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


def test_quant_matmul_gpt_medium_f32_head(card):
    """The untied f32 head of GPT-3 medium's int4 serve (f32 activations,
    M 8 x 1024 x 50304, on the CUDA cores), within 1e-5 of the largest
    output of the plain version, bit for bit across two calls."""
    rs = np.random.RandomState(50304)
    x = _randn(rs, 8, 1024).to(card)
    packed, scale = quantize_int4(_randn(rs, 1024, 50304) * 0.02)
    packed, scale = packed.to(card), scale.to(card)
    _cuda_common.reset_launch_counts()
    out = quant_matmul_raw(x, packed, scale, 1024)
    again = quant_matmul_raw(x, packed, scale, 1024)
    ref = quant_matmul_reference(x, packed, scale, 1024)
    torch.cuda.synchronize()
    assert _launched() == {"quant_matmul": 2}
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 50304)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("weight_quant,kv_cache_dtype", [
    ("none", "model"), ("int4", "int4"), ("int8", "int8")])
def test_gpt_engine_on_card_matches_cpu_engine(card, weight_quant,
                                               kv_cache_dtype):
    """A tiny f32 GPT served on the card (K1 prefill, K7 / K7q decode, K8
    for int4 weights; its graphs captured) gives the greedy tokens of the
    same model's CPU engine, and the exact launch counts: K1 layers a
    prefill, K7 layers a tick, K8 4 x layers + 1 a prefill and a tick."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops.paged_decode import KERNEL_NAMES as NAMES
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM

    torch.manual_seed(0)
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=64)
    cpu = GPTForCausalLM(cfg, device="cpu")
    gpu = GPTForCausalLM(cfg, device=card)
    gpu.set_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    stream = [(rs.randint(0, 96, (ln,)), nt)
              for ln, nt in ((3, 4), (20, 6), (2, 9), (40, 3))]
    kw = dict(max_slots=2, kv_block_size=8, weight_quant=weight_quant,
              kv_cache_dtype=kv_cache_dtype, prefix_cache=False,
              chunked_prefill_tokens=0)
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, device=dev, **kw)
        for p, nt in stream:
            eng.add_request(p, max_new_tokens=nt)
        _cuda_common.reset_launch_counts()
        out.append(eng.run())
    counts = _cuda_common.launch_counts()
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    ticks = eng.stats()["steps"]
    assert counts["flash_attention_fwd"] == len(stream) * 2
    assert counts[NAMES[kv_cache_dtype]] == ticks * 2
    assert counts["quant_matmul"] == ((len(stream) + ticks) * 9
                                      if weight_quant == "int4" else 0)
    assert eng._graph_stats()["graphs_captured"]["serving.decode"] >= 1


def test_gpt_static_generate_on_card_matches_cpu(card):
    """GPTForCausalLM.generate on the card (the static engine: K1 prefill,
    one captured decode step replayed) gives the CPU run's tokens in f32,
    with K1 launched once a layer."""
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM

    torch.manual_seed(1)
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=64)
    cpu = GPTForCausalLM(cfg, device="cpu")
    gpu = GPTForCausalLM(cfg, device=card)
    gpu.set_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 96, (3, 11)))
    want = cpu.generate(ids, max_new_tokens=13)
    _cuda_common.reset_launch_counts()
    got = gpu.generate(ids, max_new_tokens=13)
    assert _launched() == {"flash_attention_fwd": 2}
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_chunk_end_is_dated_on_the_card_without_a_wait(card):
    """The engine's open chunk spans (`_end_mark` / `_ended_at`): a mark
    recorded behind ~50 ms of device work returns at once, and once the
    device has caught up it is dated after the work was enqueued and not
    after the host saw the work end; a GPT engine's chunked prompts then
    leave no span open and every chunk span runs forward in time."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference import engine as port_engine
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM

    torch.cuda.synchronize()
    t_enq = time.perf_counter()
    torch.cuda._sleep(100_000_000)
    mark = port_engine._end_mark(card)
    t_back = time.perf_counter()
    torch.cuda.synchronize()
    t_done = time.perf_counter()
    (ended,) = port_engine._ended_at([mark], card)
    assert t_back - t_enq < 0.01 < ended - t_enq, (t_back, t_enq, ended)
    assert ended <= t_done, (ended, t_done)

    torch.manual_seed(0)
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=64)
    eng = ServingEngine(GPTForCausalLM(cfg, device=card), device=card,
                        max_slots=2, kv_block_size=8,
                        chunked_prefill_tokens=8, prefix_cache=False)
    rs = np.random.RandomState(5)
    for ln in (30, 21):
        eng.add_request(rs.randint(0, 96, (ln,)), max_new_tokens=3)
    eng.run()
    assert eng._open_chunks == []
    spans = [sp for fl in eng.flight.flights() for sp in fl.spans
             if sp[0] == "prefill_chunk"]
    assert len(spans) == eng.stats()["prefill_chunks"] == 4 + 3
    assert all(t0 < t1 for _, t0, t1, _ in spans), spans


# -------------------------------------- the training half of obs (costs)
def _counted(fn):
    """(cost dict, result) of `fn()` under the cost ledger's counter."""
    from paddle_tpu_torch.obs.costs import extract_cost

    return extract_cost(fn, torch.device("cuda"))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def test_cost_count_takes_each_kernel_once_by_its_formula(card):
    """Every kernel on the training and serving paths, under the cost
    counter on the card: one launch each, its flops by its own formula
    (the kernel table's bounds: 2·D a pair and head per product for
    K1 / K2, 2·M·K·N for K8, 4·D a head and addressable token for K7)
    and its bytes those of the tensors it reads and writes."""
    from paddle_tpu_torch.ops.quantized import quant_matmul_raw as qmm

    rs = np.random.RandomState(1)
    b, h, s, d = 1, 4, 64, 64
    q, k, v, do = (_randn(rs, b, h, s, d).to(card, torch.bfloat16)
                   for _ in range(4))
    pairs = s * (s + 1) // 2
    cost, (o, lse) = _counted(lambda: flash_attention_fwd(q, k, v, True))
    assert cost["kernels"] == {"flash_attention_fwd": 1}
    assert cost["flops"] == 2 * 2 * b * h * d * pairs
    delta = _bwd_delta(o, do)
    cost, dq = _counted(lambda: _launch_bwd_dq(q, k, v, do, lse, delta,
                                               True))
    assert cost["kernels"] == {"flash_attention_bwd_dq": 1}
    assert cost["flops"] == 3 * 2 * b * h * d * pairs
    cost, _ = _counted(lambda: _launch_bwd_dkv(q, k, v, do, lse, delta,
                                               True))
    assert cost["kernels"] == {"flash_attention_bwd_dkv": 1}
    assert cost["flops"] == 4 * 2 * b * h * d * pairs
    x = _randn(rs, 96, 256).to(card, torch.bfloat16)
    w = _randn(rs, 256).to(card, torch.bfloat16)
    cost, (y, _, rstd) = _counted(
        lambda: fused_norm.fused_rms_norm_fwd(x, None, w, 1e-6))
    assert cost["kernels"] == {"fused_rms_norm_fwd": 1}
    assert cost["flops"] == 4 * x.numel()
    assert cost["bytes_accessed"] == _nbytes(x, w, y, rstd)
    g, u = (_randn(rs, 96, 256).to(card, torch.bfloat16) for _ in range(2))
    cost, o5 = _counted(lambda: fused_norm.swiglu_fwd(g, u))
    assert cost["kernels"] == {"swiglu_fwd": 1}
    assert cost["flops"] == 6 * g.numel()
    assert cost["bytes_accessed"] == _nbytes(g, u, o5)
    xq = _randn(rs, 8, 256).to(card, torch.bfloat16)
    packed, scale = quantize_int4(_randn(rs, 256, 128).to(card))
    cost, out = _counted(lambda: qmm(xq, packed, scale, 256))
    assert cost["kernels"] == {"quant_matmul": 1}
    assert cost["flops"] == 2 * 8 * 256 * 128
    # K7: the cache the block tables can address, not the whole pool
    seqs, hkv, bs, pages = 2, 4, 16, 3
    kc, vc = (_randn(rs, 20, hkv, bs, d).to(card, torch.bfloat16)
              for _ in range(2))
    tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32,
                          device=card)
    lens = torch.tensor([40, 7], dtype=torch.int32, device=card)
    qd = _randn(rs, seqs, hkv, d).to(card, torch.bfloat16)
    cost, od = _counted(lambda: paged_decode_attention(qd, kc, vc, tables,
                                                       lens))
    assert cost["kernels"] == {"paged_decode_attention": 1}
    assert cost["flops"] == 4 * seqs * hkv * d * pages * bs
    block = 2 * hkv * bs * d * 2
    assert cost["bytes_accessed"] == seqs * pages * block + _nbytes(
        qd, tables, lens, od)


def test_cost_count_of_a_captured_step_is_its_discovery(card):
    """A to_static step on the card: its ledger row carries the
    discovery's count (K1 and K2 once each, the matmuls by torch's
    formulas) and the peak the card's allocator saw; replays add
    nothing to the row's cost."""
    from paddle_tpu_torch import jit, obs
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    m = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                         device=card, dtype=torch.bfloat16)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())

    @jit.to_static
    def card_step(x):
        loss = m(x, labels=x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 64))).to(card)
    for _ in range(5):
        card_step(x)
    disc = next(iter(card_step._discovered.values()))
    assert {k: disc.cost["kernels"].get(k) for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")} == {"flash_attention_fwd": 1,
                                        "flash_attention_bwd_dq": 1,
                                        "flash_attention_bwd_dkv": 1}
    row = [e for e in obs.ledger("to_static") if e.group == "card_step"][0]
    assert row.analyzed and row.flops == disc.cost["flops"] > 0
    assert row.peak_hbm_bytes > 0 and row.bytes_accessed > 0


def test_bf16_train_state_round_trip_is_bit_exact(card, tmp_path):
    from paddle_tpu_torch import amp, ckpt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    def build(seed):
        torch.manual_seed(seed)
        m = LlamaForCausalLM(llama_tiny_config(), device=card)
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        return amp.decorate(m, opt, level="O2", dtype="bfloat16",
                            master_weight=True)

    m, opt = build(0)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 33))).to(card)
    for _ in range(2):
        m(x, labels=x).backward()
        opt.step()
        opt.clear_grad()
    ckpt.save_checkpoint(str(tmp_path), 2, ckpt.capture_train_state(
        m, opt, step=2))
    m2, opt2 = build(5)
    r = ckpt.restore_checkpoint(str(tmp_path))
    ckpt.restore_train_state(r.tree, m2, opt2)
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              m2.state_dict().items()):
        assert a._data.dtype == b._data.dtype == torch.bfloat16, k
        assert torch.equal(a._data.view(torch.int16),
                           b._data.view(torch.int16)), k
    want = m(x, labels=x)
    want.backward()
    opt.step()
    got = m2(x, labels=x)
    got.backward()
    opt2.step()
    assert got.item() == want.item()


def test_pinned_batches_reach_the_card_non_blocking(card):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import DataLoader, Dataset

    class D(Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full((4,), i, np.float32), np.int64(i)

    for workers in (0, 2):
        dl = DataLoader(D(), batch_size=4, num_workers=workers,
                        pin_memory=True)
        for x, y in dl:
            assert x._data.is_pinned() and y._data.is_pinned()
            t = pt.Model(pt.nn.Linear(4, 2))._to_device(x, card)
            assert t._data.device.type == "cuda"
            torch.cuda.synchronize()
            np.testing.assert_array_equal(t.numpy(), x.numpy())
        if workers:
            assert dl.transport["ring"] == 2
