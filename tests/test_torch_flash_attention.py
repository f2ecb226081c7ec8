"""The port's flash-attention forward against paddle_tpu's Pallas kernel.

The plain version (`flash_attention_reference`, what the CPU path runs)
must match `paddle_tpu.ops.pallas_attention._flash_forward` run in
interpret mode, O and LSE, at <= 5e-5 in f32 (both accumulate in f32;
the bound covers summation order).
The CUDA kernel is held against the plain version on the card in
test_torch_cuda_kernels.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax.numpy as jnp
from paddle_tpu.ops.pallas_attention import _flash_forward

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_reference)

TOL = 5e-5


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, hq, sq, d).astype("float32"),
            rs.randn(b, hkv, sk, d).astype("float32"),
            rs.randn(b, hkv, sk, d).astype("float32"))


def _reference(q, k, v, causal):
    rep = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    o, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, 128, 128)
    return np.asarray(o), np.asarray(lse)[:, :, :q.shape[2], 0]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 2, 2, 128, 128, 64, True),
    (1, 2, 2, 128, 128, 64, False),
    (2, 2, 2, 40, 40, 32, True),         # ragged: one partial block
    (1, 2, 2, 40, 100, 32, True),        # causal offset sk - sq
    (1, 4, 2, 64, 64, 32, True),         # GQA, the port indexes kv heads
    (1, 4, 1, 40, 40, 16, False),        # MQA, non-causal, ragged
], ids=["causal", "full", "ragged", "offset", "gqa", "mqa-full"])
def test_plain_matches_pallas_kernel(b, hq, hkv, sq, sk, d, causal):
    q, k, v = _inputs(b, hq, hkv, sq, sk, d)
    want_o, want_lse = _reference(q, k, v, causal)
    o, lse = flash_attention_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal)
    np.testing.assert_allclose(o.numpy(), want_o, atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=0)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 33, 33, 16))
    _cuda_common.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = flash_attention_reference(q, k, v, True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert _cuda_common.launch_counts()["flash_attention_fwd"] == 0


def test_wrapper_refuses_other_devices():
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q, q, q)


def test_bf16_plain_version_close_to_f32():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 64, 64, 32))
    o32, _ = flash_attention_reference(q, k, v, True)
    o16, _ = flash_attention_reference(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16(), True)
    assert o16.dtype == torch.bfloat16
    # bf16 inputs (8-bit mantissa) then a bf16 output rounding
    np.testing.assert_allclose(o16.float().numpy(), o32.numpy(), atol=3e-2)
