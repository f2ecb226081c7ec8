"""The flash wrapper's head-dim padding against the unpadded plain version
and against paddle_tpu's flash kernel.

On the card, bf16 flash attention (K1, K2) runs tensor-core kernels that
read rows by TMA, so the head dim must be a multiple of 8: the wrapper's
`with_head_pad` pads q, k, v (o, dO) with zero columns, keeps the softmax
scale at 1/sqrt of the original d (as the reference keeps it when it pads
d to 128, `pallas_attention.py:215-218`), and cuts O, dQ, dK and dV back.
Here the same `with_head_pad` runs around the plain versions:
  * it equals the unpadded plain version at <= 1e-6 of each output's
    largest |value| (f32; zero columns add exact zeros to every dot, so
    only the summation order differs);
  * at d = 100 it agrees with paddle_tpu's `_flash_forward` /
    `_flash_backward` in interpret mode (GQA expanded, dK/dV summed over
    each group) at <= 1e-4 of each output's largest |value|, the bound of
    test_torch_flash_backward.py (f32 on both sides, summation order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax.numpy as jnp
from paddle_tpu.ops.pallas_attention import _flash_backward, _flash_forward

from paddle_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference, flash_attention_reference, with_head_pad)

TOL_SAME = 1e-6
TOL_PALLAS = 1e-4

CASES = [(1, 2, 2, 70, 70, 100, True), (1, 4, 2, 40, 96, 100, False),
         (1, 2, 1, 33, 33, 20, True)]
IDS = ["d100-causal", "d100-gqa-full", "d20-mqa"]


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, hq, sq, d).astype("float32"),
            rs.randn(b, hkv, sk, d).astype("float32"),
            rs.randn(b, hkv, sk, d).astype("float32"),
            rs.randn(b, hq, sq, d).astype("float32"))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _padded_forward(q, k, v, causal):
    seen = []

    def run(q_, k_, v_, scale):
        seen.append((q_.shape[-1], scale))
        return flash_attention_reference(q_, k_, v_, causal, None, scale)

    out = with_head_pad(run, (q, k, v))
    return out, seen


def _padded_backward(q, k, v, o, lse, do, causal):
    def run(q_, k_, v_, o_, do_, scale):
        return flash_attention_bwd_reference(q_, k_, v_, o_, lse, do_,
                                             causal, None, scale)

    return with_head_pad(run, (q, k, v, o, do))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES, ids=IDS)
def test_padding_equals_unpadded_plain_version(b, hq, hkv, sq, sk, d,
                                               causal):
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(b, hq, hkv, sq, sk, d))
    (o, lse), seen = _padded_forward(q, k, v, causal)
    # the kernels would see the padded head dim and the original scale
    assert seen == [(-(-d // 8) * 8, 1.0 / np.sqrt(d))]
    ro, rlse = flash_attention_reference(q, k, v, causal)
    assert o.shape == q.shape and o.is_contiguous()
    assert _rel(o, ro) <= TOL_SAME and _rel(lse, rlse) <= TOL_SAME
    got = _padded_backward(q, k, v, ro, rlse, do, causal)
    want = flash_attention_bwd_reference(q, k, v, ro, rlse, do, causal)
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.shape == ref.shape and g.is_contiguous()
        assert _rel(g, w) <= TOL_SAME


def test_no_padding_at_a_multiple_of_8():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 16, 16, 64))
    (o, _), seen = _padded_forward(q, k, v, True)
    assert seen == [(64, 0.125)]
    assert torch.equal(o, flash_attention_reference(q, k, v, True)[0])


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES[:2], ids=IDS[:2])
def test_padding_agrees_with_pallas_kernel(b, hq, hkv, sq, sk, d, causal):
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d)
    rep = hq // hkv
    qj, kj, vj, doj = (jnp.asarray(a) for a in
                       (q, np.repeat(k, rep, 1), np.repeat(v, rep, 1), do))
    want_o, lse_lanes = _flash_forward(qj, kj, vj, causal, 128, 128)
    want_grads = _flash_backward(qj, kj, vj, want_o, lse_lanes, doj, causal,
                                 128, 128)
    want_lse = np.asarray(lse_lanes)[:, :, :sq, 0]

    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    (o, lse), _ = _padded_forward(qt, kt, vt, causal)
    assert _rel(o, want_o) <= TOL_PALLAS
    assert _rel(lse, want_lse) <= TOL_PALLAS
    grads = _padded_backward(qt, kt, vt, o, lse, dot, causal)
    for g, w, kv in zip(grads, want_grads, (False, True, True)):
        w = np.asarray(w)
        if kv:   # the VJP of the repeat sums each group
            w = w.reshape(b, hkv, rep, *w.shape[2:]).sum(axis=2)
        assert _rel(g, w) <= TOL_PALLAS
