"""The port's chunked fused linear cross-entropy against paddle_tpu's.

The same numpy inputs go through both packages'
`fused_linear_cross_entropy` (the reference's own `TestChunkedFusedCE`
and `TestQuantizedFusedCE` cases) and through the port's unchunked plain
version, `fused_linear_cross_entropy_reference`:

  * f32: the loss within 1e-5 relative, dH and dW within 2e-6 absolute
    (the bound the reference's test holds its chunked paths to against
    its unchunked one: f32 sums over <= 1000 logits, in another order);
  * bf16 operands: the loss within 1e-4 relative (the same bf16 products
    summed in f32 on both sides) and dH, dW in bf16 within 2^-7 of each
    tensor's largest |value| (each side rounds its f32 result once to
    bf16, so they differ by at most one bf16 ulp of a value's binade);
  * the quantized head (int8, packed int4): the loss within 1e-6
    relative and dH within 1e-5 relative + 1e-7 absolute of the
    reference's (its own test's bounds against its dequantized oracle);
    the scale's gradient is zero.

The reference's eager backward runs with FLAGS_eager_defer_vjp=False
(its deferred-VJP pass reads `jax.core.Var`, which this jax no longer
has; the math is the same).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as PIF
from paddle_tpu.incubate.nn.functional import fused_loss as ref_fl

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.incubate.nn.functional import (
    fused_linear_cross_entropy, fused_linear_cross_entropy_reference)
from paddle_tpu_torch.incubate.nn.functional import fused_loss as port_fl

BF16_TOL = 2 ** -7


@pytest.fixture(autouse=True)
def ref_eager():
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)


def _inputs(n, v, hid=64, seed=0, ignore_every=7):
    rs = np.random.RandomState(seed)
    h = rs.randn(n, hid).astype("float32")
    w = (rs.randn(hid, v) * 0.05).astype("float32")
    lab = rs.randint(0, v, (n,))
    if ignore_every:
        lab[::ignore_every] = -100
    return h, w, lab.astype("int64")




def _ref(h_np, w_np, lab_np, bf16=False, **kw):
    """paddle_tpu's (loss, dH, dW) as f32 numpy."""
    h, w = paddle.to_tensor(h_np), paddle.to_tensor(w_np)
    if bf16:
        h, w = h.astype("bfloat16"), w.astype("bfloat16")
    h.stop_gradient = False
    w.stop_gradient = False
    loss = fused_linear_cross_entropy_ref(h, w, paddle.to_tensor(lab_np),
                                          **kw)
    loss.backward()
    return (float(loss), np.asarray(h.grad._data).astype("float32"),
            np.asarray(w.grad._data).astype("float32"),
            (str(h.grad.dtype), str(w.grad.dtype)))


fused_linear_cross_entropy_ref = PIF.fused_linear_cross_entropy


def _port(h_np, w_np, lab_np, bf16=False, fn=fused_linear_cross_entropy,
          transposed=True, **kw):
    """The port's (loss, dH, dW) as f32 numpy. `transposed`: w is the
    [H, V] view of a [V, H] weight; else a row-major [H, V] weight, as
    the models pass lm_head.weight."""
    h = torch.from_numpy(h_np)
    wt = torch.from_numpy(np.ascontiguousarray(w_np.T))
    if bf16:
        h, wt = h.bfloat16(), wt.bfloat16()
    h.requires_grad_(True)
    wt.requires_grad_(True)
    w = wt.T if transposed else wt.T.contiguous()
    if not transposed:
        w.retain_grad()
    loss = fn(h, w, torch.from_numpy(lab_np), **kw)
    loss.backward()
    dw = (wt.grad.T if transposed else w.grad)
    return (loss.item(), h.grad.float().numpy(), dw.float().numpy(),
            (h.grad.dtype, dw.dtype))


def _close(got, want, tol_loss=1e-5, atol=2e-6):
    assert abs(got[0] - want[0]) <= tol_loss * abs(want[0]), (got[0],
                                                              want[0])
    np.testing.assert_allclose(got[1], want[1], atol=atol)
    np.testing.assert_allclose(got[2], want[2], atol=atol)


@pytest.mark.parametrize("n,v,chunk", [(256, 1000, 128), (229, 1000, 64),
                                       (64, 50304, 64)])
def test_token_path_matches_reference(n, v, chunk):
    h, w, lab = _inputs(n, v)
    kw = dict(chunk_axis="tokens", token_chunk=chunk)
    got = _port(h, w, lab, **kw)
    _close(got, _ref(h, w, lab, **kw))
    _close(got, _port(h, w, lab, fn=fused_linear_cross_entropy_reference))


@pytest.mark.parametrize("n,v,chunk,transposed", [
    (256, 1280, 256, True), (229, 1000, 200, True), (96, 1024, 8192, False)])
def test_vocab_path_matches_reference(n, v, chunk, transposed):
    h, w, lab = _inputs(n, v, seed=5)
    kw = dict(chunk_axis="vocab", chunk_size=chunk)
    got = _port(h, w, lab, transposed=transposed, **kw)
    _close(got, _ref(h, w, lab, **kw))
    _close(got, _port(h, w, lab, fn=fused_linear_cross_entropy_reference))


def test_token_path_matches_vocab_path():
    h, w, lab = _inputs(192, 1024, hid=32, seed=1, ignore_every=0)
    tok = _port(h, w, lab, chunk_axis="tokens", token_chunk=64)
    voc = _port(h, w, lab, chunk_axis="vocab", chunk_size=128)
    _close(tok, voc)
    assert abs(tok[0] - _ref(h, w, lab, chunk_axis="vocab",
                             chunk_size=128)[0]) < 1e-5


def test_best_chunk_and_auto_axis_for_50304():
    assert port_fl._best_chunk(50304, 8192) == 0
    assert port_fl._best_chunk(32000, 8192) == 6400
    for v in (50, 1000, 4096, 30522, 32000, 50304, 128256):
        for cs in (0, 64, 1000, 8192):
            assert port_fl._best_chunk(v, cs) == ref_fl._best_chunk(v, cs)
    h, w, lab = _inputs(32, 50304, hid=16, seed=2, ignore_every=0)
    got = _port(h, w, lab, chunk_axis="auto")
    _close(got, _ref(h, w, lab, chunk_axis="auto"))
    _close(got, _port(h, w, lab, fn=fused_linear_cross_entropy_reference))


def test_flags_steer_the_axis():
    assert flag("FLAGS_flce_chunk_axis") == "auto"
    assert flag("FLAGS_flce_token_chunk") == 1024
    h, w, lab = _inputs(100, 512, hid=16, seed=6)
    tok = _port(h, w, lab, chunk_axis="tokens", token_chunk=32)
    set_flags({"FLAGS_flce_chunk_axis": "tokens",
               "FLAGS_flce_token_chunk": 32})
    try:
        by_flag = _port(h, w, lab)
    finally:
        set_flags({"FLAGS_flce_chunk_axis": "auto",
                   "FLAGS_flce_token_chunk": 1024})
    assert by_flag[0] == tok[0]
    np.testing.assert_array_equal(by_flag[1], tok[1])
    np.testing.assert_array_equal(by_flag[2], tok[2])


@pytest.mark.parametrize("axis", ["tokens", "vocab"])
def test_bf16_gradients_in_bf16(axis):
    h, w, lab = _inputs(128, 512, seed=3, ignore_every=0)
    kw = dict(chunk_axis=axis, token_chunk=128, chunk_size=128)
    got = _port(h, w, lab, bf16=True, **kw)
    want = _ref(h, w, lab, bf16=True, **kw)
    assert got[3] == (torch.bfloat16, torch.bfloat16)
    assert want[3] == ("bfloat16", "bfloat16")
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    for g, r in ((got[1], want[1]), (got[2], want[2])):
        assert np.abs(g - r).max() <= BF16_TOL * np.abs(r).max()
    plain = _port(h, w, lab, fn=fused_linear_cross_entropy_reference)
    assert abs(got[0] - plain[0]) / abs(plain[0]) < 3e-2


@pytest.mark.parametrize("axis", ["tokens", "vocab"])
def test_all_ignored_chunk(axis):
    h, w, lab = _inputs(128, 256, hid=16, seed=4, ignore_every=0)
    lab[64:] = -100                    # the second token chunk: all ignored
    kw = dict(chunk_axis=axis, token_chunk=64, chunk_size=64)
    got = _port(h, w, lab, **kw)
    _close(got, _ref(h, w, lab, **kw))
    assert not got[1][64:].any()
    lab[:] = -100                      # nothing to learn: loss and grads 0
    none = _port(h, w, lab, **kw)
    assert none[0] == 0.0 and not none[1].any() and not none[2].any()


def test_unchunked_path_when_chunk_size_is_zero():
    h, w, lab = _inputs(60, 300, hid=16, seed=7)
    kw = dict(chunk_axis="vocab", chunk_size=0)
    got = _port(h, w, lab, **kw)
    _close(got, _ref(h, w, lab, **kw))


def test_gpt_loss_path_fused_matches_logits():
    from paddle_tpu.text.models.gpt import GPTConfig as PGPTConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as PGPT

    from paddle_tpu_torch.text.models import GPTConfig, gpt_from_numpy

    kw = dict(vocab_size=50304, hidden_size=32, num_hidden_layers=1,
              num_attention_heads=2, max_position_embeddings=64)
    paddle.seed(0)
    ref = PGPT(PGPTConfig(**kw))
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = gpt_from_numpy(GPTConfig(**kw), state, device="cpu")
    ids = np.random.RandomState(0).randint(0, 50304, (2, 64))
    t = torch.from_numpy(ids)
    loss = port(t, labels=t)
    logits = port(t)
    want = torch.nn.functional.cross_entropy(logits.float().reshape(
        -1, 50304), t.reshape(-1))
    assert abs(loss.item() - want.item()) < 1e-4
    ref_loss = float(ref(paddle.to_tensor(ids), paddle.to_tensor(ids)))
    assert abs(loss.item() - ref_loss) < 1e-4


def _quant_pair(vocab, algo, group_size=-1):
    rs = np.random.RandomState(10)
    h = (rs.randn(12, 64) * 0.3).astype("float32")
    w = (rs.randn(64, vocab) * 0.1).astype("float32")
    lab = rs.randint(0, vocab, (12,)).astype("int64")
    q, s = PIF.weight_quantize(paddle.to_tensor(w), algo=algo,
                               group_size=group_size)
    return h, np.asarray(q._data), np.asarray(s._data), lab


def _quant_loss(h_np, q_np, s_np, lab_np, port, **kw):
    if port:
        h = torch.from_numpy(h_np).requires_grad_(True)
        s = torch.from_numpy(s_np.copy()).requires_grad_(True)
        loss = fused_linear_cross_entropy(
            h, (torch.from_numpy(q_np.copy()), s), torch.from_numpy(lab_np),
            **kw)
        loss.backward()
        return loss.item(), h.grad.numpy(), s.grad
    h = paddle.to_tensor(h_np)
    h.stop_gradient = False
    loss = PIF.fused_linear_cross_entropy(
        h, (paddle.to_tensor(q_np), paddle.to_tensor(s_np)),
        paddle.to_tensor(lab_np), **kw)
    loss.backward()
    return float(loss), np.asarray(h.grad._data), None


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("vocab", [256, 251])
def test_quantized_head_matches_reference(algo, vocab):
    """vocab 256 takes the chunked quantized path (chunk 128), 251 (no
    multiple-of-128 divisor) dequantizes the head once and takes the
    token path."""
    h, q, s, lab = _quant_pair(vocab, algo)
    got = _quant_loss(h, q, s, lab, True, chunk_size=128)
    want = _quant_loss(h, q, s, lab, False, chunk_size=128)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    if vocab == 256:
        assert got[2] is not None and not got[2].any()


def test_quantized_group_wise_scales_raise():
    h, q, s, lab = _quant_pair(256, "weight_only_int4", group_size=32)
    assert s.shape == (2, 256)
    with pytest.raises(NotImplementedError, match="group-wise scales"):
        _quant_loss(h, q, s, lab, True)
