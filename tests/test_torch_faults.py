"""Shapes the reference computes and the port's kernels used to refuse.

Three faults of the port against paddle_tpu, each pinned here on the CPU
(the kernels' plain versions), and on the card in
test_torch_cuda_kernels.py:
  * F1: paged decode at GQA groups off {1, 2, 4, 8, 16} and head dims
    above 128: the port's `paged_decode_attention` against the
    reference's (its XLA composition here), its `_check` accepting the
    shapes the kernels now take, head dims off multiples of 8 sent to
    the plain version as the reference's gate sends them to its
    composition, and tiny LLaMAs with groups 3 and 7 and with head dim
    256 serving the greedy tokens of paddle_tpu's engine (prefix cache
    off, whole-prompt prefill);
  * F2: flash attention at head dims 192 and 256 through
    `scaled_dot_product_attention`, `flash_attn_unpadded` and
    `flashmask_attention`, forward and gradients, against the
    reference's public functions, and `_check` / `_check_fm` accepting
    d 256;
  * F3: the routed norms (`rms_norm`, `fused_add_rms_norm`, `layer_norm`,
    `fused_add_layer_norm`, `FLAGS_pallas_fused_ops` on) at hidden
    16384, at `MAX_HIDDEN_LN` + 8 and at 0 rows against the reference's,
    and `_check_norm` accepting wide rows.
Tolerances: f32 5e-5 of max(1, the largest |value|) (f32 sums in another
order); bf16 decode 3e-2 (bf16 inputs and output rounding, as
test_torch_paged_decode.py); greedy tokens exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax.numpy as jnp
from paddle_tpu.core.flags import flag as ref_flag
from paddle_tpu.core.flags import set_flags as ref_set_flags
from paddle_tpu.inference import engine as jax_engine
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.pallas_decode import \
    paged_decode_attention as ref_paged_decode
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops import fused_norm
from paddle_tpu_torch.ops.flash_attention import MAX_HEAD_DIM, _check
from paddle_tpu_torch.ops.flashmask import _check_fm
from paddle_tpu_torch.ops.paged_decode import (_check as decode_check,
                                               kernel_gate_reason,
                                               paged_decode_attention)
from paddle_tpu_torch.text.models import LlamaConfig, llama_from_numpy

TOL = 5e-5


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
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, (err, bound)


# ------------------------------------------------------------------ F1

DECODE_SHAPES = [(12, 4, 128), (32, 1, 128), (8, 8, 256), (8, 8, 100)]
DECODE_IDS = ["group3", "group32", "d256", "d100"]


def _decode_inputs(hq, hkv, d, s=2, bs=16, pages=3, blocks=12, seed=0):
    rs = np.random.RandomState(seed + hq + d)
    q = rs.randn(s, hq, d).astype("float32")
    kc, vc = (rs.randn(blocks, hkv, bs, d).astype("float32")
              for _ in range(2))
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = ids.reshape(s, pages).astype("int32")
    lens = np.array([1, pages * bs - 5], "int32")[:s]
    return q, kc, vc, tables, lens


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("hq,hkv,d", DECODE_SHAPES, ids=DECODE_IDS)
def test_paged_decode_matches_reference(hq, hkv, d, dtype, tol):
    args = _decode_inputs(hq, hkv, d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = ref_paged_decode(*(jnp.asarray(a, jdt) for a in args[:3]),
                            *(jnp.asarray(a) for a in args[3:]))
    got = paged_decode_attention(*(torch.from_numpy(a).to(tdt)
                                   for a in args[:3]),
                                 *(torch.from_numpy(a) for a in args[3:]))
    assert got.dtype == tdt and tuple(got.shape) == (2, hq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("hq,hkv,d", DECODE_SHAPES, ids=DECODE_IDS)
def test_paged_decode_check_takes_the_reference_shapes(hq, hkv, d):
    """The kernels' checks accept every group and head dims that are
    multiples of 8 up to 256, in all three cache formats; a head dim off
    a multiple of 8 has a gate reason (the plain version runs on the
    card too), and the raw check refuses it."""
    q, kc, _, tables, lens = (torch.from_numpy(a)
                              for a in _decode_inputs(hq, hkv, d))
    q = q.bfloat16()
    codes = torch.zeros(kc.shape, dtype=torch.int8)
    scale = torch.ones(kc.shape[0])
    formats = [("model", kc.bfloat16(), None),
               ("int8", codes, scale),
               ("int4", codes[:, :, :kc.shape[2] // 2].contiguous(), scale)]
    for fmt, cache, sc in formats:
        call = (fmt, q, cache, cache, tables, lens, sc, sc)
        if d % 8:
            assert kernel_gate_reason(d) is not None
            with pytest.raises(ValueError, match="head_dim"):
                decode_check(*call)
        else:
            assert kernel_gate_reason(d) is None
            decode_check(*call)


_KW = dict(vocab_size=128, intermediate_size=64, num_hidden_layers=2,
           max_position_embeddings=64)
_STREAM = ((3, 4), (7, 6), (2, 9), (11, 4))


@pytest.mark.parametrize("heads,kv_heads,hidden", [(6, 2, 48), (7, 1, 56),
                                                   (2, 2, 512)],
                         ids=["group3", "group7", "d256"])
def test_engine_serves_like_reference(heads, kv_heads, hidden):
    kw = dict(_KW, hidden_size=hidden, num_attention_heads=heads,
              num_key_value_heads=kv_heads)
    paddle.seed(0)
    ref = PLlamaForCausalLM(PLlamaConfig(**kw))
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = llama_from_numpy(LlamaConfig(**kw), state, device="cpu")
    a = jax_engine.ServingEngine(ref, max_slots=2, kv_block_size=8,
                                 prefix_cache=False,
                                 chunked_prefill_tokens=0)
    b = ServingEngine(port, max_slots=2, kv_block_size=8, device="cpu")
    rs = np.random.RandomState(3)
    for ln, nt in _STREAM:
        p = rs.randint(0, 128, (ln,))
        assert a.add_request(p, max_new_tokens=nt) \
            == b.add_request(p, max_new_tokens=nt)
    want, got = a.run(), b.run()
    assert sorted(want) == sorted(got) == list(range(len(_STREAM)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


# ------------------------------------------------------------------ F2

def _grads(out, leaves, do):
    """(out, dq, dk, dv) as numpy, from loss = sum(out * do)."""
    if isinstance(out, torch.Tensor):
        (out * torch.from_numpy(do)).sum().backward()
        return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    (out * paddle.to_tensor(do)).sum().backward()
    return [out.numpy()] + [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("d", [192, 256])
def test_sdpa_at_wide_head_dims_matches_reference(d):
    rs = np.random.RandomState(d)
    q, k, v, do = (rs.randn(1, 40, 2, d).astype("float32") * 0.5
                   for _ in range(4))
    ref = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    want = _grads(RF.scaled_dot_product_attention(*ref, is_causal=True),
                  ref, do)
    port = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = _grads(PF.scaled_dot_product_attention(*port, is_causal=True),
                 port, do)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("d", [192, 256])
def test_varlen_and_flashmask_at_wide_head_dims_match_reference(d):
    rs = np.random.RandomState(d + 1)
    lens = [30, 7, 21]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype("int32")
    q, k, v, do = (rs.randn(cu[-1], 2, d).astype("float32") * 0.5
                   for _ in range(4))
    ref = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out, _ = RF.flash_attn_unpadded(*ref, paddle.to_tensor(cu),
                                    paddle.to_tensor(cu), max(lens),
                                    max(lens), causal=True)
    want = _grads(out, ref, do)
    port = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, _ = PF.flash_attn_unpadded(*port, torch.from_numpy(cu),
                                    torch.from_numpy(cu), max(lens),
                                    max(lens), causal=True)
    for g, w in zip(_grads(out, port, do), want):
        _close(g, w)
    s = 48
    q, k, v, do = (rs.randn(1, s, 2, d).astype("float32") * 0.5
                   for _ in range(4))
    # start rows that leave each row its own key (the reference's dense
    # path gives a row with no key NaN)
    idx = np.minimum(np.arange(s) + 1 + rs.randint(0, s, (1, 2, s)),
                     s).astype("int32")[..., None]
    ref = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    want = _grads(RF.flashmask_attention(*ref, paddle.to_tensor(idx),
                                         causal=True), ref, do)
    port = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = _grads(PF.flashmask_attention(*port, torch.from_numpy(idx),
                                        causal=True), port, do)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("d", [136, 192, 256])
def test_flash_checks_take_head_dims_to_256(d):
    q = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
    start = torch.ones(1, 2, 8, dtype=torch.int32)
    _check(q, q, q)
    _check_fm(q, q, q, start)
    wide = torch.zeros(1, 2, 8, MAX_HEAD_DIM + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        _check(wide, wide, wide)


# ------------------------------------------------------------------ F3

NORM_SHAPES = [(2, 16384), (3, fused_norm.MAX_HIDDEN_LN + 8), (0, 64)]
NORM_IDS = ["h16384", "ln-max-plus-8", "empty"]


@pytest.fixture
def fused_flag():
    old = flag("FLAGS_pallas_fused_ops")
    set_flags({"FLAGS_pallas_fused_ops": True})
    yield
    set_flags({"FLAGS_pallas_fused_ops": old})


def _norm_calls(kind, mod, x, r, w, b):
    h = x.shape[-1]
    if kind == "rms":
        return mod.rms_norm(x, w)
    if kind == "add_rms":
        return mod.fused_add_rms_norm(x, r, w)[0]
    if kind == "ln":
        return mod.layer_norm(x, h, w, b)
    return mod.fused_add_layer_norm(x, r, w, b)[0]


@pytest.mark.parametrize("kind", ["rms", "add_rms", "ln", "add_ln"])
@pytest.mark.parametrize("rows,h", NORM_SHAPES, ids=NORM_IDS)
def test_routed_norms_take_wide_and_empty_rows(fused_flag, kind, rows, h):
    """The routed norms, forward and gradients (x, residual, weight,
    bias), against the reference's at rows wider than the shared-memory
    kernels hold and at 0 rows; no kernel is counted on the CPU."""
    rs = np.random.RandomState(rows + h)
    x, r, do = (rs.randn(rows, h).astype("float32") for _ in range(3))
    w, b = (rs.randn(h).astype("float32") for _ in range(2))
    arrays = (x + 4.0, r, w, b)
    ref = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = _norm_calls(kind, RF, *ref)
    (out * paddle.to_tensor(do)).sum().backward()
    want = [out.numpy()] + [np.zeros_like(a) if t.grad is None
                            else t.grad.numpy() for a, t in zip(arrays, ref)]
    port = [torch.from_numpy(a).requires_grad_() for a in arrays]
    _cuda_common.reset_launch_counts()
    out = _norm_calls(kind, PF, *port)
    (out * torch.from_numpy(do)).sum().backward()
    got = [out.detach().numpy()] + [np.zeros_like(a) if t.grad is None
                                    else t.grad.numpy()
                                    for a, t in zip(arrays, port)]
    assert not any(_cuda_common.launch_counts().values())
    for g, wnt in zip(got, want):
        _close(g, wnt)


@pytest.mark.parametrize("h", [fused_norm.MAX_HIDDEN + 8, 16384, 65536])
def test_check_norm_takes_wide_rows_and_refuses_empty(h):
    """The kernels' checks accept rows of any width (past MAX_HIDDEN /
    MAX_HIDDEN_LN the kernels take their wide path) and refuse an empty
    tensor, which the routed ops keep from them."""
    x = torch.zeros(2, h, dtype=torch.bfloat16)
    fused_norm._check_norm("RMS", x, (x[0],), x.dtype, torch.float32, x)
    w = torch.zeros(h)
    fused_norm._check_norm("LN", x, (w, w), torch.float32, x.dtype)
    with pytest.raises(ValueError, match="rows of"):
        fused_norm._check_norm("RMS", x[:0], (x[0],), x.dtype, x.dtype)
