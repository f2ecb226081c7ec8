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
values of magnitude ~1, 2^-8 relative). The dequant-matmul and the flash
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
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


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
                                       (torch.bfloat16, 2 ** -7)])
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
    q = torch.zeros(1, 2, 8, 16, device=card, dtype=torch.float16)
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
    gpu.load_state_dict(cpu.state_dict())
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
    gpu.load_state_dict(cpu.state_dict())
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
                                            (torch.bfloat16, 2e-2, 2 ** -7)])
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
                                            (torch.bfloat16, 2e-2, 2 ** -7)])
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
    gpu.load_state_dict(cpu.state_dict())
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
