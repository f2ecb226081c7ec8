"""The flash backward's delta from the unrounded O (CPU, the kernels'
plain versions; the card's kernels in test_torch_cuda_kernels.py).

K2's dS = P (dP - delta) with delta = rowsum(dO * O). Where the keys'
values nearly agree, dP - delta cancels. The reference's Pallas backward
(`paddle_tpu/ops/pallas_attention.py`, `_flash_backward`) and FlashAttention
2 take delta from the forward's O rounded to bf16, which leaves an error
of |dO| |O| 2^-9 in it. The port's forwards give O's rounding residual
(`flash_attention_fwd(..., residual=True)`, `flashmask_fwd` likewise) on
every route, and its differentiable ops take delta from o + o_res, the
forward's f32 O. Here: the residual restores O in f32 (and is zero in
f32); on values spread 2^-6 around a common row, the backward with it
meets an f64 autograd truth within 2^-6 of each gradient's largest value,
where the rounded O's delta misses by more; without the residual the
port's backward is the reference's Pallas backward (run in interpret
mode) within one bf16 ulp; and the autograd Functions save the residual
and use it.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax.numpy as jnp
from paddle_tpu.ops.pallas_attention import _flash_backward, _flash_forward

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flashmask as fm

TOL_BF16 = 2 ** -7
SPREAD = 2 ** -6


def _inputs(spread, seed=0):
    """bf16 q, k, dO [2, 4, 64, 32] and v within `spread` of one row."""
    rs = np.random.RandomState(seed)
    q, k, do = (torch.from_numpy(rs.randn(2, 4, 64, 32).astype("float32"))
                for _ in range(3))
    base = torch.from_numpy(rs.randn(2, 4, 1, 32).astype("float32"))
    v = base + spread * torch.from_numpy(
        rs.randn(2, 4, 64, 32).astype("float32"))
    return [t.to(torch.bfloat16) for t in (q, k, v, do)]


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def test_residual_restores_o_in_f32():
    q, k, v, _ = _inputs(1.0)
    o, lse, res = fa.flash_attention_fwd(q, k, v, True, residual=True)
    o32, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                          True)
    assert res.dtype == torch.bfloat16 and res.shape == o.shape
    exact = (o.float() + res.float() - o32).abs().max().item()
    rounded = (o.float() - o32).abs().max().item()
    assert exact <= 2 ** -16 * o32.abs().max().item() < rounded


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_residual_on_every_dtype(dtype):
    q, k, v, _ = (t.to(getattr(torch, dtype)) for t in _inputs(1.0, seed=2))
    o, lse, res = fa.flash_attention_fwd(q, k, v, False, residual=True)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, False)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert res.dtype == o.dtype and res.shape == o.shape
    if dtype == "float32":
        assert not res.any()
    else:
        # within half a unit in the last place of o
        ulp = 2 ** -8 if dtype == "bfloat16" else 2 ** -11
        assert (res.float().abs() <= ulp * o.float().abs() + 2 ** -24).all()
        assert res.any()


@pytest.mark.parametrize("causal", [True, False])
def test_backward_with_the_residual_meets_f64_on_near_equal_values(causal):
    q, k, v, do = _inputs(SPREAD)
    truth = [t.double().requires_grad_() for t in (q, k, v)]
    o64, _ = fa.flash_attention_reference(*truth, causal)
    (o64 * do.double()).sum().backward()
    want = [t.grad for t in truth]
    o, lse, res = fa.flash_attention_fwd(q, k, v, causal, residual=True)
    ours = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, o_res=res)
    rounded = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    for i in (0, 1):                       # dQ, dK: the cancelling ones
        err, old = _rel(ours[i], want[i]), _rel(rounded[i], want[i])
        assert err <= 2 ** -6 < old, (i, err, old)
    assert _rel(ours[2], want[2]) <= TOL_BF16


@pytest.mark.parametrize("causal", [True, False])
def test_without_the_residual_the_backward_is_the_references(causal):
    q, k, v, do = _inputs(SPREAD)
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v, do)]
    o, lse = _flash_forward(*jx[:3], causal, 128, 128)
    want = [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in
            _flash_backward(*jx[:3], o, lse, jx[3], causal, 128, 128)]
    o = torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(lse)[:, :, :q.shape[2], 0])
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL_BF16, _rel(g, w)
    # the port's differentiable op departs from it on these values
    _, _, res = fa.flash_attention_fwd(q, k, v, causal, residual=True)
    ours = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, o_res=res)
    assert _rel(ours[0], want[0]) > TOL_BF16


def test_autograd_function_saves_and_uses_the_residual():
    q, k, v, do = _inputs(SPREAD, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = fa.flash_attention(*leaves, True)
    o.backward(do)
    o_, lse, res = fa.flash_attention_fwd(q, k, v, True, residual=True)
    want = fa.flash_attention_bwd(q, k, v, o_, lse, do, True, o_res=res)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_flashmask_saves_and_uses_the_residual():
    q, k, v, do = _inputs(SPREAD, seed=3)
    start = torch.from_numpy(np.random.RandomState(3).randint(
        0, 65, (2, 4, 64)).astype(np.int32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fm.flashmask_attention_raw(*leaves, start, True)
    o.backward(do)
    o_, lse, res = fm.flashmask_fwd(q, k, v, start, True, residual=True)
    assert torch.equal(o.detach(), o_)
    want = fm.flashmask_bwd(q, k, v, o_, lse, do, start, True, o_res=res)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    rounded = fm.flashmask_bwd(q, k, v, o_, lse, do, start, True)
    assert not torch.equal(rounded[0], want[0])
