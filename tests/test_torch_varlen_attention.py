"""The port's varlen attention (K1v/K2v and the varlen APIs) against
paddle_tpu.

* The plain versions of K1v and K2v (`flash_attention_fwd` /
  `flash_attention_bwd` with kv_lens on CPU tensors, what the kernels are
  held to on the card) against the reference's `flash_attention_varlen_raw`
  run in interpret mode (its `_fwd_kernel` / `_bwd_*_kernel` with
  `has_lens`), forward and gradients, on the valid query rows only (rows
  past a sequence's length are computed and dropped; with causal masking
  they are not zero), at 5e-5 in f32 (both accumulate in f32; the bound
  covers summation order), scaled by the largest |value| where that is
  above 1. The dK/dV of key columns past a length must be exactly 0. In
  bf16 both compute in f32 from the same bf16 inputs and round each
  gradient once, so they differ by at most one bf16 ulp: 2^-7 of the
  largest |value|.
* `flash_attn_unpadded`, `flash_attn_varlen_qkvpacked` and the incubate
  `memory_efficient_attention` against the reference's functions, through
  both of the port's routes: the kernel route (cu_q == cu_k, no dropout)
  and the composition route (cu_q != cu_k, bottom-right causal by actual
  lengths). On the CPU the reference always takes its composition (it
  takes its kernel only on a TPU), so the kernel route is held to the
  reference's composition: on valid rows they compute the same function.
  Forward and gradients at 5e-5 (as above).
Dropout draws from torch's generator in the port and from JAX's in the
reference, so dropout is tested for shape, keep rate and route only.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax
import jax.numpy as jnp
from paddle_tpu.core.flags import flag as ref_flag
from paddle_tpu.core.flags import set_flags as ref_set_flags
from paddle_tpu.incubate.nn.functional import \
    memory_efficient_attention as ref_mea
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.pallas_attention import (_flash_backward, _flash_forward,
                                             flash_attention_varlen_raw)

from paddle_tpu_torch.incubate.nn.functional import \
    memory_efficient_attention
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import extended
from paddle_tpu_torch.ops.flash_attention import (
    EMPTY_ROW_LSE, flash_attention_bwd, flash_attention_fwd,
    flash_attention_varlen_raw as port_varlen_raw)

TOL = 5e-5
TOL_BF16 = 2 ** -7
LENS = [96, 40, 7, 0]


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


def _padded(hq, hkv, s=96, d=32, seed=0):
    rs = np.random.RandomState(seed)
    b = len(LENS)
    return (rs.randn(b, hq, s, d).astype("float32"),
            rs.randn(b, hkv, s, d).astype("float32"),
            rs.randn(b, hkv, s, d).astype("float32"),
            rs.randn(b, hq, s, d).astype("float32"))


def _valid(s):
    """[B, 1, S, 1] float: 1 on the query rows inside each length."""
    return (np.arange(s)[None, :] < np.asarray(LENS)[:, None]) \
        .astype("float32")[:, None, :, None]


@pytest.mark.parametrize("hq,hkv,causal", [(2, 2, True), (2, 2, False),
                                           (4, 2, True)],
                         ids=["causal", "full", "gqa-causal"])
def test_plain_k1v_k2v_match_pallas_varlen(hq, hkv, causal):
    q, k, v, do = _padded(hq, hkv)
    valid = _valid(q.shape[2])
    do = do * valid                  # the gather-back's backward
    lens = jnp.asarray(LENS, jnp.int32)
    out, vjp = jax.vjp(lambda a, b_, c: flash_attention_varlen_raw(
        a, b_, c, lens, causal=causal), *map(jnp.asarray, (q, k, v)))
    want = (np.asarray(out),) + tuple(map(np.asarray, vjp(jnp.asarray(do))))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kv_lens = torch.tensor(LENS, dtype=torch.int32)
    o, lse = flash_attention_fwd(tq, tk, tv, causal, kv_lens)
    grads = flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal, kv_lens)
    _close(o.numpy() * valid, want[0] * valid)
    for g, w in zip(grads, want[1:]):
        _close(g.numpy(), w)
    # the sequence of length 0: lse -1e30, o 0, no gradient anywhere
    assert (lse[3] == EMPTY_ROW_LSE).all() and (o[3] == 0).all()
    # key columns past a length get exactly zero dK/dV
    for b, n in enumerate(LENS):
        assert not grads[1][b, :, n:].any() and not grads[2][b, :, n:].any()

    # the differentiable op gives the same gradients through autograd
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    port_varlen_raw(*leaves, kv_lens, causal).backward(tdo)
    for leaf, g in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


def test_plain_k2v_matches_pallas_in_bf16():
    q, k, v, do = _padded(2, 2, seed=1)
    do = do * _valid(q.shape[2])
    lens = jnp.asarray(LENS, jnp.int32)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    o, lse = _flash_forward(*bf[:3], True, 128, 128, lens=lens)
    want = _flash_backward(*bf[:3], o, lse, bf[3], True, 128, 128,
                           lens=lens)
    to_t = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
            for a in (*bf, o)]
    tlse = torch.from_numpy(np.array(lse)[:, :, :q.shape[2], 0])
    grads = flash_attention_bwd(to_t[0], to_t[1], to_t[2], to_t[4], tlse,
                                to_t[3], True,
                                torch.tensor(LENS, dtype=torch.int32))
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
               TOL_BF16)


# ------------------------------------------------------ the public functions

#: packed sequences: q lengths, and the k lengths of the composition route
#: (each >= its q length, so every valid row sees a key)
LQ = [37, 5, 64, 20]
LK = [40, 9, 50, 33]


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype("int32")


def _packed(total_q, total_k, h=2, d=32, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(total_q, h, d).astype("float32"),
            rs.randn(total_k, h, d).astype("float32"),
            rs.randn(total_k, h, d).astype("float32"),
            rs.randn(total_q, h, d).astype("float32"))


def _ref_unpadded(q, k, v, do, cu_q, cu_k, causal, scale):
    leaves = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out, _ = RF.flash_attn_unpadded(
        *leaves, paddle.to_tensor(cu_q), paddle.to_tensor(cu_k),
        max(np.diff(cu_q)), max(np.diff(cu_k)), scale=scale, causal=causal)
    (out * paddle.to_tensor(do)).sum().backward()
    return [np.asarray(out.numpy())] + [np.asarray(t.grad.numpy())
                                        for t in leaves]


@pytest.mark.parametrize("route,causal,scale", [
    ("kernel", True, None), ("kernel", False, 0.3),
    ("composition", True, None), ("composition", False, 0.3)])
def test_flash_attn_unpadded_matches_reference(route, causal, scale,
                                               monkeypatch):
    lk = LQ if route == "kernel" else LK
    cu_q, cu_k = _cu(LQ), _cu(lk)
    q, k, v, do = _packed(cu_q[-1], cu_k[-1])
    want = _ref_unpadded(q, k, v, do, cu_q, cu_k, causal, scale)

    taken = []
    real = extended.flash_attention_varlen_raw
    monkeypatch.setattr(extended, "flash_attention_varlen_raw",
                        lambda *a, **kw: taken.append(1) or real(*a, **kw))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, none = PF.flash_attn_unpadded(
        *leaves, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
        max(LQ), max(lk), scale=scale, causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    assert none is None and bool(taken) == (route == "kernel")
    for got, w in zip([out.detach()] + [t.grad for t in leaves], want):
        _close(got.numpy(), w)


@pytest.mark.parametrize("route", ["kernel", "composition"])
def test_qkvpacked_and_memory_efficient_match_reference(route):
    lk = LQ if route == "kernel" else LK
    cu_q, cu_k = _cu(LQ), _cu(lk)
    q, k, v, _ = _packed(cu_q[-1], cu_k[-1], seed=4)
    if route == "kernel":
        qkv = np.stack([q, k, v], axis=1)            # [total, 3, H, D]
        want, _ = RF.flash_attn_varlen_qkvpacked(
            paddle.to_tensor(qkv), paddle.to_tensor(cu_q),
            paddle.to_tensor(cu_q), max(LQ), max(LQ), causal=True)
        got, _ = PF.flash_attn_varlen_qkvpacked(
            torch.from_numpy(qkv), torch.from_numpy(cu_q),
            torch.from_numpy(cu_q), max(LQ), max(LQ), causal=True)
        _close(got.numpy(), want.numpy())
    kw = dict(max_seqlen_q=max(LQ), max_seqlen_k=max(lk), causal=True,
              scale=0.2)
    want = ref_mea(*map(paddle.to_tensor, (q, k, v)),
                   cu_seqlens_q=paddle.to_tensor(cu_q),
                   cu_seqlens_k=paddle.to_tensor(cu_k), **kw)
    got = memory_efficient_attention(*map(torch.from_numpy, (q, k, v)),
                                     cu_seqlens_q=torch.from_numpy(cu_q),
                                     cu_seqlens_k=torch.from_numpy(cu_k),
                                     **kw)
    _close(got.numpy(), want.numpy())


def test_memory_efficient_attention_without_cu_seqlens_is_sdpa():
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 24, 4, 16).astype("float32") for _ in range(3))
    bias = np.where(rs.rand(2, 1, 24, 24) < 0.2, -1e4, 0.0) \
        .astype("float32")
    for b in (None, bias):
        kw = dict(causal=b is None, scale=0.4)
        want = ref_mea(*map(paddle.to_tensor, (q, k, v)),
                       bias=None if b is None else paddle.to_tensor(b), **kw)
        got = memory_efficient_attention(
            *map(torch.from_numpy, (q, k, v)),
            bias=None if b is None else torch.from_numpy(b), **kw)
        _close(got.numpy(), want.numpy())


def test_varlen_dropout_takes_the_composition(monkeypatch):
    """dropout > 0 (training) leaves the kernel route: the output has the
    packed shape, about 1 - p of the probabilities survive, and with
    training=False the kernel route is back and dropout is off."""
    def refuse(*a, **kw):
        raise AssertionError("the varlen kernel route was taken")

    cu = _cu([64, 64])
    x = torch.zeros(128, 2, 64)
    # uniform attention over each sequence's 64 keys, v = one-hot rows:
    # each output element is one probability (1/64), kept and scaled or 0
    v = torch.eye(64).repeat(2, 1)[:, None, :].expand(128, 2, 64)
    monkeypatch.setattr(extended, "flash_attention_varlen_raw", refuse)
    torch.manual_seed(0)
    out, _ = PF.flash_attn_unpadded(x, x, v.contiguous(), cu, cu, 64, 64,
                                    dropout=0.25)
    assert out.shape == (128, 2, 64)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02, kept
    assert torch.allclose(out[out != 0], torch.tensor(1 / 64 / 0.75))
    monkeypatch.undo()
    out, _ = PF.flash_attn_unpadded(x, x, v.contiguous(), cu, cu, 64, 64,
                                    dropout=0.25, training=False)
    torch.testing.assert_close(out, torch.full_like(out, 1 / 64))


def test_return_softmax_is_refused():
    cu = _cu([4])
    x = torch.zeros(4, 1, 8)
    with pytest.raises(NotImplementedError, match="return_softmax"):
        PF.flash_attn_unpadded(x, x, x, cu, cu, 4, 4, return_softmax=True)
    with pytest.raises(NotImplementedError, match="return_softmax"):
        PF.flash_attn_varlen_qkvpacked(torch.zeros(4, 3, 1, 8), cu, cu, 4,
                                       4, return_softmax=True)
