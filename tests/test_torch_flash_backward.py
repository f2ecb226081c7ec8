"""The port's flash-attention backward and differentiable op against
paddle_tpu.

The plain backward (`flash_attention_bwd_reference`, what the CPU path
runs and what the K2 kernels are held to on the card; it is the plain
versions of the two kernels, dQ and dK/dV, one after the other) must
match, from
the same q, k, v, o, lse and dO:
  * paddle_tpu's Pallas backward `_flash_backward` run in interpret mode
    with 128-blocks (the kernels K2 replaces), and
  * `jax.vjp` of the reference's XLA composition `_xla_sdpa`,
at <= 1e-4 of each output's largest |value| in f32 (all accumulate in
f32; the bound covers summation order over a few hundred keys). The XLA
composition gives a causal row that sees no key (Sq > Sk) a uniform
softmax where the kernels give it zero, so that case is held to the
Pallas oracle alone. In bf16 the port and the Pallas oracle compute in
f32 from the same bf16 inputs and round each output once to bf16, so they
differ by at most one bf16 ulp: 2^-7 of the largest |value|.
The CUDA kernels are held against the plain version on the card in
test_torch_cuda_kernels.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax
import jax.numpy as jnp
from paddle_tpu.nn.functional.attention import _xla_sdpa
from paddle_tpu.ops.pallas_attention import _flash_backward, _flash_forward

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops.flash_attention import (
    EMPTY_ROW_LSE, flash_attention, flash_attention_bwd,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)

TOL = 1e-4
TOL_BF16 = 2 ** -7

CASES = [
    (2, 2, 2, 130, 130, 64, True),        # MHA, ragged: a partial block
    (1, 8, 2, 96, 96, 32, True),          # GQA 4:1
    (1, 4, 1, 70, 70, 16, False),         # GQA 4:1, full, ragged
    (1, 2, 2, 40, 100, 32, True),         # causal offset sk - sq
    (1, 4, 2, 100, 40, 32, False),        # Sq > Sk, full
]
IDS = ["mha-ragged", "gqa", "gqa-full-ragged", "offset", "sq-gt-sk-full"]
EMPTY_ROWS = (1, 4, 2, 100, 40, 32, True)  # Sq > Sk causal: 60 empty rows


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, hq, sq, d).astype("float32"),
            rs.randn(b, hkv, sk, d).astype("float32"),
            rs.randn(b, hkv, sk, d).astype("float32"),
            rs.randn(b, hq, sq, d).astype("float32"))


def _pallas(q, k, v, do, causal, dtype=jnp.float32):
    """(o, lse, (dq, dk, dv)) of the Pallas kernels in interpret mode; GQA
    K/V are repeated as `flash_attention_raw` does, and dK/dV summed over
    each group as the VJP of the repeat does."""
    rep = q.shape[1] // k.shape[1]
    qj, kj, vj, doj = (jnp.asarray(a).astype(dtype) for a in
                       (q, np.repeat(k, rep, 1), np.repeat(v, rep, 1), do))
    o, lse = _flash_forward(qj, kj, vj, causal, 128, 128)
    dq, dk, dv = _flash_backward(qj, kj, vj, o, lse, doj, causal, 128, 128)

    def group(x):
        x = np.asarray(x.astype(jnp.float32))
        b, h, s, d = x.shape
        return x.reshape(b, h // rep, rep, s, d).sum(axis=2)

    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(lse)[:, :, :q.shape[2], 0],
            (np.asarray(dq.astype(jnp.float32)), group(dk), group(dv)))


def _xla(q, k, v, do, causal):
    """(dq, dk, dv) by jax.vjp of the reference's XLA composition, in its
    [B, S, H, D] layout."""
    t = lambda a: jnp.asarray(a).swapaxes(1, 2)     # noqa: E731
    _, vjp = jax.vjp(lambda a, b_, c: _xla_sdpa(a, b_, c, None, 0.0,
                                                causal, None),
                     t(q), t(k), t(v))
    return tuple(np.asarray(g).swapaxes(1, 2) for g in vjp(t(do)))


def _port_bwd(q, k, v, o, lse, do, causal):
    return [g.numpy() for g in flash_attention_bwd_reference(
        *(torch.from_numpy(np.array(a))
          for a in (q, k, v, o, lse, do)), causal)]


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(np.asarray(g, np.float32) - w).max()
        assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES, ids=IDS)
def test_plain_backward_matches_pallas_and_xla(b, hq, hkv, sq, sk, d,
                                               causal):
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d)
    o, lse, want = _pallas(q, k, v, do, causal)
    got = _port_bwd(q, k, v, o, lse, do, causal)
    _close(got, want, TOL)
    _close(got, _xla(q, k, v, do, causal), TOL)


def test_plain_backward_rows_that_see_no_key():
    """Sq > Sk causal: the first Sq - Sk rows see no key. Their forward
    output is 0 and lse -1e30 (the Pallas kernel's and K1's values), and
    they add nothing to dK/dV (masked probabilities are zeroed, not left
    to exp(-1e30 - lse))."""
    b, hq, hkv, sq, sk, d, causal = EMPTY_ROWS
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d)
    o, lse, want = _pallas(q, k, v, do, causal)
    po, plse = flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    empty = sq - sk
    assert (po[:, :, :empty] == 0).all() and \
        (plse[:, :, :empty] == EMPTY_ROW_LSE).all()
    np.testing.assert_allclose(po.numpy(), o, atol=5e-5, rtol=0)
    got = _port_bwd(q, k, v, o, lse, do, causal)
    assert all(np.isfinite(g).all() for g in got)
    assert (got[0][:, :, :empty] == 0).all()
    _close(got, want, TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [CASES[1], CASES[2]],
                         ids=["gqa", "gqa-full-ragged"])
def test_per_kernel_plain_versions(b, hq, hkv, sq, sk, d, causal):
    """The plain version of each K2 kernel, from the kernel's inputs
    (delta = rowsum(dO * O) in f32): together they are the plain backward,
    and the dK/dV one sums each group's q heads, as dK/dV of K/V repeated
    to every q head would (the reference's repeat and its VJP)."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(b, hq, hkv, sq, sk, d, seed=4))
    o, lse = flash_attention_fwd(q, k, v, causal)
    delta = (do * o).sum(dim=-1)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal)
    whole = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    assert all(torch.equal(g, w) for g, w in zip((dq, dk, dv), whole))
    rep = hq // hkv
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    dkr, dvr = flash_attention_bwd_dkv_reference(q, kr, vr, do, lse, delta,
                                                 causal)
    group = lambda x: x.reshape(b, hkv, rep, sk, d).sum(2)  # noqa: E731
    _close([dk.numpy(), dv.numpy()],
           [group(dkr).numpy(), group(dvr).numpy()], TOL)
    _close([dq.numpy()], [flash_attention_bwd_dq_reference(
        q, kr, vr, do, lse, delta, causal).numpy()], TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [CASES[1]], ids=["gqa"])
def test_bf16_plain_backward_matches_pallas(b, hq, hkv, sq, sk, d, causal):
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d, seed=1)
    bf = lambda a: torch.from_numpy(np.array(a)).bfloat16()  # noqa: E731
    # both sides see the same bf16-rounded inputs
    q, k, v, do = (bf(a).float().numpy() for a in (q, k, v, do))
    o, lse, want = _pallas(q, k, v, do, causal, jnp.bfloat16)
    got = flash_attention_bwd_reference(
        bf(q), bf(k), bf(v), bf(o), torch.from_numpy(np.array(lse)), bf(do),
        causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close([g.float().numpy() for g in got], want, TOL_BF16)


@pytest.mark.parametrize("hq,hkv,sq,sk,causal", [
    (2, 2, 6, 6, True), (4, 2, 7, 5, False), (4, 1, 5, 9, True),
    (2, 1, 7, 4, True)], ids=["mha", "gqa-full", "mqa-offset", "empty-rows"])
def test_op_gradcheck_f64(hq, hkv, sq, sk, causal):
    """The differentiable op (its plain forward and backward on the CPU)
    passes torch.autograd.gradcheck in f64."""
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(1, h, s, 8)).requires_grad_()
               for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: flash_attention(a, b_, c, causal)[0], (q, k, v))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal",
                         [CASES[0], CASES[1], EMPTY_ROWS],
                         ids=["mha-ragged", "gqa", "empty-rows"])
def test_op_matches_autograd_of_plain_forward(b, hq, hkv, sq, sk, d,
                                              causal):
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(b, hq, hkv, sq, sk, d, seed=3))
    for t in (q, k, v):
        t.requires_grad_()
    o, lse = flash_attention(q, k, v, causal)
    assert lse.grad_fn is None and not lse.requires_grad
    got = torch.autograd.grad(o, (q, k, v), do)
    ro, _ = flash_attention_reference(q, k, v, causal)
    want = torch.autograd.grad(ro, (q, k, v), do)
    _close([g.numpy() for g in got], [w.numpy() for w in want], TOL)


def test_op_under_no_grad_is_the_forward():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 33, 33, 16))
    q.requires_grad_()
    with torch.no_grad():
        o, lse = flash_attention(q, k, v, causal=True)
    ro, rlse = flash_attention_fwd(q, k, v, causal=True)
    assert o.grad_fn is None and torch.equal(o, ro) \
        and torch.equal(lse, rlse)
    o2, _ = flash_attention(q.detach(), k, v, causal=True)  # no grad wanted
    assert o2.grad_fn is None


def test_bwd_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 33, 33, 16))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    _cuda_common.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    counts = _cuda_common.launch_counts()
    assert counts["flash_attention_bwd_dq"] == 0 \
        and counts["flash_attention_bwd_dkv"] == 0


def test_bwd_wrapper_refuses_other_devices():
    q = torch.empty(1, 2, 8, 16, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(q, q, q, q, lse, q)
