"""The port's FlashMask attention (K9 and `flashmask_attention`) against
paddle_tpu.

* The plain versions of K9 (`flashmask_fwd` / `flashmask_bwd` on CPU
  tensors, what the kernels are held to on the card) against the
  reference's `flashmask_attention_raw` run in interpret mode with
  128-blocks (its `_fm_fwd_kernel`, `_fm_bwd_dq_kernel` and
  `_fm_bwd_dkv_kernel`), forward and gradients, causal and not: random
  start rows at S 256, a ragged S (200: the reference pads its kv blocks),
  a sliding window whose start rows hide whole tiles, and fully hidden
  columns (dK = dV = 0 exactly). f32 at 5e-5 (both accumulate in f32;
  the bound covers summation order), scaled by the largest |value| where
  that is above 1; bf16 gradients at one bf16 ulp, 2^-7 of the largest
  |value| (both compute in f32 from the same bf16 inputs and round each
  once).
* The tile bounds (`tile_bounds`) against the reference's
  `_fm_starts_prep`, padded columns excluded from smin.
* `flashmask_attention` against the reference's function for the causal
  [LTS] form (the port's K9 route; on the CPU the reference takes its
  dense mask, which computes the same function wherever every row sees a
  key), [LTS, LTE], the non-causal [LTS, UTE] and [LTS, LTE, UTS, UTE]
  (both dense), with start rows broadcast from Hm = 1, and GQA (dense).
  The inputs leave every row at least one key (start[j] > j, end[j] <= j):
  the reference's dense path gives NaN for a row that every column hides,
  the kernel route 0.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax
import jax.numpy as jnp
from paddle_tpu.core.flags import flag as ref_flag
from paddle_tpu.core.flags import set_flags as ref_set_flags
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops import pallas_attention as pa

from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import extended
from paddle_tpu_torch.ops.flash_attention import EMPTY_ROW_LSE
from paddle_tpu_torch.ops.flashmask import (flashmask_attention_raw,
                                            flashmask_bwd, flashmask_fwd,
                                            tile_bounds)

TOL = 5e-5
TOL_BF16 = 2 ** -7


@pytest.fixture(autouse=True)
def _eager_vjp():
    """The reference's eager backward with its deferred-VJP pass off (the
    pass reads the removed `jax.core.Var` on this jax)."""
    old = ref_flag("FLAGS_eager_defer_vjp")
    ref_set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref_set_flags({"FLAGS_eager_defer_vjp": old})


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, (err, bound)


def _inputs(s=256, seed=0, b=2, h=2, d=64):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, s, d).astype("float32") * 0.3,
            rs.randn(b, h, s, d).astype("float32") * 0.3,
            rs.randn(b, h, s, d).astype("float32"),
            rs.randn(b, h, s, d).astype("float32"))


def _window(b, h, s, w):
    return np.broadcast_to((np.arange(s) + w).clip(0, s).astype("int32"),
                           (b, h, s)).copy()


def _random_starts(b, h, s, seed):
    return np.random.RandomState(seed).randint(1, s + 1, (b, h, s)) \
        .astype("int32")


def _pallas(q, k, v, do, start, causal, dtype=jnp.float32):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b_, c: pa.flashmask_attention_raw(
        a, b_, c, jnp.asarray(start), causal=causal, block_q=128,
        block_k=128), *args)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


CASES = {
    "random": (256, lambda b, h, s: _random_starts(b, h, s, 7)),
    "ragged": (200, lambda b, h, s: _random_starts(b, h, s, 8)),
    "window": (256, lambda b, h, s: _window(b, h, s, 64)),
    "hidden-columns": (256, lambda b, h, s: np.concatenate(
        [np.zeros((b, h, 128), "int32"),
         _random_starts(b, h, s, 9)[..., 128:]], axis=-1)),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_k9_matches_pallas(case, causal):
    s, make = CASES[case]
    q, k, v, do = _inputs(s, seed=len(case))
    start = make(2, 2, s)
    want = _pallas(q, k, v, do, start, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    ts = torch.from_numpy(start)
    o, lse = flashmask_fwd(tq, tk, tv, ts, causal)
    grads = flashmask_bwd(tq, tk, tv, o, lse, tdo, ts, causal)
    for got, w in zip((o, *grads), want):
        _close(got.numpy(), w)
    if case == "hidden-columns":
        assert not grads[1][..., :128, :].any()
        assert not grads[2][..., :128, :].any()
    # the differentiable op gives the same gradients through autograd
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    flashmask_attention_raw(*leaves, ts, causal).backward(tdo)
    for leaf, g in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


def test_plain_k9_backward_matches_pallas_in_bf16():
    q, k, v, do = _inputs(256, seed=11)
    start = _random_starts(2, 2, 256, 12)
    want = _pallas(q, k, v, do, start, True, jnp.bfloat16)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    ts = torch.from_numpy(start)
    o, lse = flashmask_fwd(tq, tk, tv, ts, True)
    for got, w in zip(flashmask_bwd(tq, tk, tv, o, lse, tdo, ts, True),
                      want[1:]):
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), w, TOL_BF16)


def test_empty_rows_get_zero_and_no_gradient():
    """A row that every start row hides (start 0 everywhere in one head)
    gets o = 0, lse = -1e30, and sends nothing back."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(64, seed=13))
    start = torch.from_numpy(_random_starts(2, 2, 64, 14))
    start[1, 0] = 0
    o, lse = flashmask_fwd(q, k, v, start, True)
    dq, dk, dv = flashmask_bwd(q, k, v, o, lse, do, start, True)
    assert (o[1, 0] == 0).all() and (lse[1, 0] == EMPTY_ROW_LSE).all()
    assert not dq[1, 0].any() and not dk[1, 0].any() and not dv[1, 0].any()
    assert torch.isfinite(dq).all() and dq[0].abs().max() > 0


@pytest.mark.parametrize("s", [256, 200, 4100])
def test_tile_bounds_match_reference_prep(s):
    start = _random_starts(2, 3, s, 15)
    start[0, 0, :64] = 0
    nk = -(-s // 64)
    _, smin_l, smax_l = pa._fm_starts_prep(jnp.asarray(start), 2, 3, s,
                                           nk * 64, nk, 64)
    smin, smax = tile_bounds(torch.from_numpy(start), s)
    np.testing.assert_array_equal(smin.numpy(),
                                  np.asarray(smin_l)[..., 0, 0])
    np.testing.assert_array_equal(smax.numpy(),
                                  np.asarray(smax_l)[..., 0, 0])
    assert smin.dtype == smax.dtype == torch.int32


def test_raw_op_refuses_gqa():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="Hq == Hkv"):
        flashmask_attention_raw(q, k, k, torch.ones(1, 4, 8,
                                                    dtype=torch.int32))


# -------------------------------------------------- the public function


def _startend(b, hm, s, nc, causal, seed):
    """[B, Hm, S, nc] int32 bands that leave each row its own key: the
    first band starts after the row (start[j] >= j + 1), the band below
    the diagonal ends at or before it (end[j] <= j)."""
    rs = np.random.RandomState(seed)
    j = np.arange(s)
    lts = np.minimum(j + 1 + rs.randint(0, s, (b, hm, s)), s)
    cols = [lts]
    if nc == 2 and causal:                                         # LTE
        cols.append(np.minimum(lts + rs.randint(0, s, (b, hm, s)), s))
    elif nc == 2:                                                  # UTE
        cols.append(rs.randint(0, 1 << 30, (b, hm, s)) % (j + 1))
    elif nc == 4:
        lte = np.minimum(lts + rs.randint(0, s, (b, hm, s)), s)
        ute = rs.randint(0, 1 << 30, (b, hm, s)) % (j + 1)
        uts = rs.randint(0, 1 << 30, (b, hm, s)) % (ute + 1)
        cols += [lte, uts, ute]
    return np.stack(cols, axis=-1).astype("int32")


@pytest.mark.parametrize("nc,causal,hm,hkv", [
    (1, True, 1, 4), (1, True, 4, 4), (2, True, 1, 4), (2, False, 4, 4),
    (4, False, 1, 4), (1, True, 1, 2)],
    ids=["lts-hm1", "lts", "lts-lte", "lts-ute", "four", "lts-gqa"])
def test_flashmask_attention_matches_reference(nc, causal, hm, hkv,
                                               monkeypatch):
    b, s, h, d = 2, 96, 4, 32
    rs = np.random.RandomState(nc + hm)
    q = rs.randn(b, s, h, d).astype("float32")
    k, v = (rs.randn(b, s, hkv, d).astype("float32") for _ in range(2))
    do = rs.randn(b, s, h, d).astype("float32")
    idx = _startend(b, hm, s, nc, causal, seed=nc)

    leaves = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out = RF.flashmask_attention(*leaves, paddle.to_tensor(idx),
                                 causal=causal)
    (out * paddle.to_tensor(do)).sum().backward()
    want = [out.numpy()] + [t.grad.numpy() for t in leaves]

    taken = []
    real = extended.flashmask_attention_raw
    monkeypatch.setattr(extended, "flashmask_attention_raw",
                        lambda *a, **kw: taken.append(1) or real(*a, **kw))
    tleaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = PF.flashmask_attention(*tleaves, torch.from_numpy(idx),
                                 causal=causal)
    (got * torch.from_numpy(do)).sum().backward()
    assert bool(taken) == (nc == 1 and hkv == h)
    for g, w in zip([got.detach()] + [t.grad for t in tleaves], want):
        _close(g.numpy(), w)


def test_flashmask_attention_errors_and_dropout(monkeypatch):
    x = torch.zeros(1, 16, 2, 8)
    for nc, causal in ((2, False), (4, True)):
        with pytest.raises(ValueError, match="last dim must be"):
            PF.flashmask_attention(x, x, x, torch.ones(1, 1, 16, nc + 1,
                                                       dtype=torch.int32),
                                   causal=causal)

    def refuse(*a, **kw):
        raise AssertionError("the K9 route was taken")

    monkeypatch.setattr(extended, "flashmask_attention_raw", refuse)
    # dropout leaves the kernel route: uniform attention over the 64 keys
    # (q = 0, [LTS, UTE] = [S, 0] hides nothing), v = one-hot rows, so
    # every output element is one probability, kept and scaled or dropped
    s = 64
    q = torch.zeros(2, s, 2, s)
    v = torch.eye(s)[None, :, None, :].expand(2, s, 2, s).contiguous()
    idx = torch.zeros(2, 1, s, 2, dtype=torch.int32)
    idx[..., 0] = s
    torch.manual_seed(0)
    out = PF.flashmask_attention(q, q, v, idx, dropout=0.25)
    assert out.shape == (2, s, 2, s)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02, kept
    assert torch.allclose(out[out != 0], torch.tensor(1 / s / 0.75))
    # the causal [LTS] form with dropout: the dense mask, not K9
    idx = torch.full((2, 1, s, 1), s, dtype=torch.int32)
    assert PF.flashmask_attention(q, q, v, idx, dropout=0.25,
                                  causal=True).shape == (2, s, 2, s)
