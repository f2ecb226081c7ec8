"""The port's masked `scaled_dot_product_attention` against paddle_tpu's.

A mask, or dropout in training, takes the reference's plain composition
(`_xla_sdpa`): k/v heads repeated for GQA, f32 softmax, probabilities in
q's dtype. Held to `paddle_tpu.nn.functional.scaled_dot_product_attention`
on the same numpy inputs at 5e-5 in f32 (the same arithmetic in another
summation order), with a bool mask and an additive one, causal and not,
MHA and GQA (Hq 8, Hkv 2; and the q [1, 8, 4, 16], k/v [1, 8, 2, 16] case
that raised before the repair). Dropout draws from torch's generator in
the port and from JAX's in the reference, so it is tested for shape, keep
rate, repeatability from one seeded generator, and `training=False` being
the identity.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as RF

from paddle_tpu_torch.nn import functional as PF

TOL = 5e-5


def _inputs(b, s, hq, hkv, d, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, hq, d).astype("float32")
    k, v = (rs.randn(b, s, hkv, d).astype("float32") for _ in range(2))
    return q, k, v, rs


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 16, 8, 2, 32),
                                          (1, 8, 4, 2, 16),
                                          (2, 16, 4, 4, 32)],
                         ids=["gqa-8-2", "gqa-4-2", "mha"])
def test_masked_sdpa_matches_reference(b, s, hq, hkv, d, causal, kind):
    q, k, v, rs = _inputs(b, s, hq, hkv, d, seed=hq + hkv + s)
    keep = rs.rand(b, 1, s, s) < 0.7
    keep[..., 0] = True                       # every row keeps a key
    mask = keep if kind == "bool" else \
        np.where(keep, 0.0, -1e4).astype("float32") + \
        rs.randn(b, 1, s, s).astype("float32") * 0.1
    want = RF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)), attn_mask=paddle.to_tensor(mask),
        is_causal=causal)
    got = PF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), attn_mask=torch.from_numpy(mask),
        is_causal=causal)
    assert got.shape == (b, s, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=TOL, rtol=0)


def _one_hot_case(s=64, h=4):
    """q = 0 (uniform attention over the S keys) and v = one-hot rows, so
    each output element is one probability, 1/S, kept and scaled or 0."""
    q = torch.zeros(2, s, h, s)
    v = torch.eye(s)[None, :, None, :].expand(2, s, h, s).contiguous()
    return q, v, torch.ones(2, 1, s, s, dtype=torch.bool)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_dropout_keep_rate_and_scale(masked):
    q, v, mask = _one_hot_case()
    p = 0.3
    gen = torch.Generator().manual_seed(1)
    out = PF.scaled_dot_product_attention(q, q, v, mask if masked else None,
                                          dropout_p=p, generator=gen)
    assert out.shape == q.shape
    kept = (out != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 0.02, kept
    torch.testing.assert_close(out[out != 0],
                               torch.full_like(out[out != 0],
                                               1 / 64 / (1 - p)))
    again = PF.scaled_dot_product_attention(
        q, q, v, mask if masked else None, dropout_p=p,
        generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(again, out, rtol=0, atol=0)


def test_dropout_off_outside_training():
    q, k, v, rs = _inputs(2, 16, 8, 2, 32, seed=3)
    mask = torch.from_numpy(rs.rand(2, 1, 16, 16) < 0.8)
    mask[..., 0] = True
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for m in (mask, None):
        want = PF.scaled_dot_product_attention(tq, tk, tv, m, is_causal=True)
        got = PF.scaled_dot_product_attention(tq, tk, tv, m, dropout_p=0.5,
                                              is_causal=True, training=False)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
