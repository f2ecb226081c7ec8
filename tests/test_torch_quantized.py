"""The port's low-bit weight storage and its dequant-matmul against
paddle_tpu's (the reference).

(a) Packing and quantizers give identical bytes and scales: `int4_pack` /
`int4_unpack` over all 256 byte values, odd K and a non-zero axis;
`quantize_int4` on f32 and bf16 weights, per-channel and grouped; the
int8 weight rule `_quantize_w` against `weight_quantize_raw`.
(b) The plain version of the dequant-matmul kernel (`quant_matmul_reference`,
what the CPU path runs) against paddle_tpu's Pallas kernel
`quant_matmul_raw` (interpret mode) and its XLA composition
(`quant_matmul` off-TPU): f32 at <= 5e-5 (f32 accumulation on every
side, in another order). bf16 is tiered by the roundings each side makes,
each at most 2^-8 relative (bf16 keeps 8 significant bits): the Pallas
kernel, like the plain version, accumulates in f32 and rounds once, so
the two differ by at most 2^-8; the XLA composition rounds the bf16
product and then the scaled result, so it differs from the plain version
by at most 3 * 2^-8.
The CUDA kernel is held against the plain version on the card in
test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (flag registry + x64 init)
import jax.numpy as jnp
from paddle_tpu.incubate.nn.functional import weight_quantize_raw
from paddle_tpu.ops import quantized as ref_q

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops import quantized as port_q
from paddle_tpu_torch.text.generation import _quantize_w


def _bf16_np(a):
    """bf16 numpy (ml_dtypes) -> torch bf16, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
        torch.bfloat16)


def _weights(dtype, shape, seed=0):
    """The same weight in both frameworks, from a seeded numpy draw."""
    w = np.random.RandomState(seed).randn(*shape).astype("float32") * 0.05
    if dtype == "bfloat16":
        jw = jnp.asarray(w, jnp.bfloat16)
        return jw, _bf16_np(np.asarray(jw))
    return jnp.asarray(w), torch.from_numpy(w)


# ------------------------------------------------------ (a) packing rules

def test_unpack_all_256_bytes():
    p = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for k in (32, 31):                              # even and odd K
        want = np.asarray(ref_q.int4_unpack(jnp.asarray(p), k, axis=0))
        got = port_q.int4_unpack(torch.from_numpy(p), k, axis=0).numpy()
        np.testing.assert_array_equal(got, want)
    # every byte survives unpack -> pack unchanged
    back = port_q.int4_pack(port_q.int4_unpack(torch.from_numpy(p), 32))
    np.testing.assert_array_equal(back.numpy(), p)


@pytest.mark.parametrize("shape,axis", [((9, 6), 0), ((4, 7, 5), 1),
                                        ((3, 11, 4), -2), ((5, 8), -1)])
def test_pack_matches_reference(shape, axis):
    q = np.random.RandomState(1).randint(-8, 8, shape).astype(np.int8)
    want = np.asarray(ref_q.int4_pack(jnp.asarray(q), axis=axis))
    got = port_q.int4_pack(torch.from_numpy(q), axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)
    k = shape[axis]
    assert got.shape[axis] == port_q.packed_rows(k) == ref_q.packed_rows(k)
    np.testing.assert_array_equal(
        port_q.int4_unpack(got, k, axis=axis).numpy(), q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", [((24, 16), -1), ((24, 16), 8),
                                         ((3, 33, 8), -1), ((2, 32, 8), 16)],
                         ids=["channel", "grouped", "stacked-odd-k",
                              "stacked-grouped"])
def test_quantize_int4_identical_bytes_and_scales(dtype, shape, group):
    jw, tw = _weights(dtype, shape)
    wp, ws = ref_q.quantize_int4(jw, group_size=group)
    gp, gs = port_q.quantize_int4(tw, group_size=group)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert gs.dtype == torch.float32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    k = shape[-2]
    np.testing.assert_array_equal(
        port_q.dequant_int4(gp, gs, k).numpy(),
        np.asarray(ref_q.dequant_int4(wp, ws, k)))


def test_group_size_must_divide():
    with pytest.raises(ValueError, match="group_size"):
        port_q.quantize_int4(torch.zeros(10, 4), group_size=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_weight_rule_matches_weight_quantize_raw(dtype):
    jw, tw = _weights(dtype, (40, 24), seed=2)
    wq, ws = weight_quantize_raw(jw)
    gq, gs = _quantize_w(tw)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ------------------------------------------------ (b) the dequant-matmul

def _qmm_inputs(dtype, m=5, k=64, n=256, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype("float32")
    w = rs.randn(k, n).astype("float32") * 0.05
    packed, scale = ref_q.quantize_int4(jnp.asarray(w))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    tx = _bf16_np(np.asarray(jx)) if dtype == "bfloat16" \
        else torch.from_numpy(x)
    return (jx, packed, scale), (tx, torch.from_numpy(np.array(packed)),
                                 torch.from_numpy(np.array(scale)))


@pytest.mark.parametrize("dtype,rtol_kernel,rtol_xla",
                         [("float32", 0, 0),
                          ("bfloat16", 2 ** -8, 3 * 2 ** -8)])
@pytest.mark.parametrize("m", [1, 5, 17])
def test_plain_matches_pallas_and_xla(dtype, rtol_kernel, rtol_xla, m):
    (jx, jp, js), (tx, tp, ts) = _qmm_inputs(dtype, m=m)
    k = jx.shape[1]
    got = port_q.quant_matmul_reference(tx, tp, ts, k)
    assert got.dtype == tx.dtype and got.shape == (m, 256)
    got = got.float().numpy()
    for want, rtol in ((ref_q.quant_matmul_raw(jx, jp, js, k), rtol_kernel),
                       (ref_q.quant_matmul(jx, jp, js), rtol_xla)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=5e-5)


def test_routed_int4_reaches_the_wrapper_and_keeps_lead_dims():
    (jx, jp, js), (tx, tp, ts) = _qmm_inputs("float32", m=6)
    x3 = tx.reshape(2, 3, 64)
    calls = []

    def spy(x2, p, s, k):
        calls.append(tuple(x2.shape))
        return port_q.quant_matmul_reference(x2, p, s, k)

    out = port_q.quant_matmul(x3, tp, ts, int4_matmul=spy)
    assert calls == [(6, 64)] and tuple(out.shape) == (2, 3, 256)
    want = np.asarray(ref_q.quant_matmul(jx.reshape(2, 3, 64), jp, js))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("grouped", [False, True], ids=["channel", "grouped"])
def test_routed_int8_and_grouped_int4_match_reference(grouped):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 32).astype("float32")
    w = rs.randn(32, 64).astype("float32") * 0.05
    q8, s8 = weight_quantize_raw(jnp.asarray(w))
    if grouped:   # int8 pair with [G, N] scales: the reference's own math
        s8 = jnp.asarray(rs.rand(4, 64).astype("float32") * 0.01)
    want = np.asarray(ref_q.quant_matmul(jnp.asarray(x), q8, s8))
    got = port_q.quant_matmul(torch.from_numpy(x),
                              torch.from_numpy(np.array(q8)),
                              torch.from_numpy(np.array(s8)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    p4, s4 = ref_q.quantize_int4(jnp.asarray(w),
                                 group_size=8 if grouped else -1)
    want = np.asarray(ref_q.quant_matmul(jnp.asarray(x), p4, s4))
    got = port_q.quant_matmul(torch.from_numpy(x),
                              torch.from_numpy(np.array(p4)),
                              torch.from_numpy(np.array(s4)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("k,n,dtype,grouped,takes", [
    (2048, 5504, torch.bfloat16, False, True),
    (2048, 32000, torch.float32, False, True),
    (64, 64, torch.float32, True, False),
    (33, 64, torch.float32, False, False),
    (64, 48, torch.bfloat16, False, False),
    (64, 64, torch.float16, False, False)],
    ids=["serve-bf16", "lm-head-f32", "grouped", "odd-k", "n48", "f16"])
def test_kernel_gate_and_routing(k, n, dtype, grouped, takes):
    """The static K8 gate (the port's `quant_gate_reason`): per-channel
    serving shapes in f32/bf16 go to the kernel's wrapper; group-wise
    scales, odd K, N % 32 and f16 x to the reference's composition, which
    `quant_matmul` then computes exactly as the reference does."""
    reason = port_q.kernel_gate_reason(k, n, dtype, grouped)
    assert (reason is None) == takes, reason
    if k * n > 1 << 16:
        return
    rs = np.random.RandomState(k + n)
    x = rs.randn(3, k).astype("float32")
    w = rs.randn(k, n).astype("float32") * 0.05
    p4, s4 = ref_q.quantize_int4(jnp.asarray(w), group_size=16 if grouped
                                 else -1)
    jdt = {torch.float32: jnp.float32, torch.float16: jnp.float16,
           torch.bfloat16: jnp.bfloat16}[dtype]
    want = np.asarray(ref_q.quant_matmul(jnp.asarray(x).astype(jdt), p4,
                                         s4).astype(jnp.float32))
    calls = []

    def spy(*args):
        calls.append(1)
        return port_q.quant_matmul_reference(*args)

    got = port_q.quant_matmul(torch.from_numpy(x).to(dtype),
                              torch.from_numpy(np.array(p4)),
                              torch.from_numpy(np.array(s4)),
                              int4_matmul=spy)
    assert bool(calls) == takes and got.dtype == dtype
    tol = 5e-5 if dtype == torch.float32 else 2 ** -7
    assert np.abs(got.float().numpy() - want).max() \
        <= tol * np.abs(want).max()


def test_routed_rejects_mismatched_rows():
    with pytest.raises(ValueError, match="match neither"):
        port_q.quant_matmul(torch.zeros(2, 32), torch.zeros(20, 8,
                                                            dtype=torch.int8),
                            torch.ones(8))


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    _, (tx, tp, ts) = _qmm_inputs("float32")
    _cuda_common.reset_launch_counts()
    out = port_q.quant_matmul_raw(tx, tp, ts, 64)
    assert torch.equal(out, port_q.quant_matmul_reference(tx, tp, ts, 64))
    assert _cuda_common.launch_counts()["quant_matmul"] == 0


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 2048, 5504),
                                   (8, 5504, 2048), (1, 2048, 32000),
                                   (512, 2048, 5504), (2, 64, 32),
                                   (3, 2, 64)])
def test_kernel_k_splits_cover_k_once(m, k, n):
    splits, rows = port_q.kernel_splits(m, k, n)
    kh = k // 2
    assert splits >= 1 and rows >= 1
    assert (splits - 1) * rows < kh <= splits * rows     # none empty
    blocks = (n // port_q.KERNEL_COLS) * -(-m // port_q.KERNEL_ROWS)
    if blocks >= port_q._TARGET_BLOCKS:
        assert splits == 1          # enough column tiles: no second pass
    else:
        assert blocks * splits >= min(port_q._TARGET_BLOCKS,
                                      blocks * (kh // 128))
