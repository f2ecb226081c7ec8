"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs a CUDA card (marker `cuda`) and skips without one.
The file imports neither jax nor paddle_tpu, so it runs where the port
runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` keeps tests/conftest.py, which sets up jax, out.) The
plain versions are themselves held against paddle_tpu in
test_torch_flash_attention.py, test_torch_paged_decode.py and
test_torch_quantized.py on the CPU. Tolerances: f32 1e-4 (f32
accumulation in another order); bf16 2e-2 (bf16 output rounding of
values of magnitude ~1, 2^-8 relative). The dequant-matmul and the flash
backward are compared relative to the largest output (their outputs grow
with K and with the sequence): f32 1e-5 / 1e-4, bf16 2^-7 (each side
rounds its f32 sum once to bf16, so the two differ by at most one bf16
ulp, 2^-7 of a value's binade).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops.flash_attention import (
    _bwd_delta, _launch_bwd_dkv, _launch_bwd_dq, flash_attention,
    flash_attention_bwd, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq_reference, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference)
from paddle_tpu_torch.ops.paged_decode import (
    KERNEL_NAMES, paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.ops.quantized import (quant_matmul, quant_matmul_raw,
                                            quant_matmul_reference,
                                            quantize_int4)

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype("float32"))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 16, 16, 500, 500, 128, True), (2, 8, 2, 77, 77, 64, True),
    (1, 4, 4, 130, 130, 128, False), (1, 4, 1, 40, 100, 32, True)])
def test_flash_kernel_matches_plain(card, dtype, tol, b, hq, hkv, sq, sk, d,
                                    causal):
    rs = np.random.RandomState(0)
    q = _randn(rs, b, hq, sq, d).to(card, dtype)
    k = _randn(rs, b, hkv, sk, d).to(card, dtype)
    v = _randn(rs, b, hkv, sk, d).to(card, dtype)
    before = _cuda_common.launch_counts()["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()["flash_attention_fwd"] == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() < tol
    assert (lse - rlse).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 16, 16, 500, 500, 128, True), (1, 16, 4, 512, 512, 128, True),
    (2, 8, 2, 77, 77, 64, True), (1, 4, 4, 130, 130, 128, False),
    (1, 4, 1, 100, 40, 32, True), (1, 4, 2, 40, 100, 16, False)],
    ids=["ragged", "gqa", "gqa-small", "full", "empty-rows", "full-sk"])
def test_flash_backward_kernels_match_plain(card, dtype, tol, b, hq, hkv, sq,
                                            sk, d, causal):
    rs = np.random.RandomState(5)
    q = _randn(rs, b, hq, sq, d).to(card, dtype)
    k = _randn(rs, b, hkv, sk, d).to(card, dtype)
    v = _randn(rs, b, hkv, sk, d).to(card, dtype)
    do = _randn(rs, b, hq, sq, d).to(card, dtype)
    o, lse = flash_attention_fwd(q, k, v, causal)
    before = _cuda_common.launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    after = _cuda_common.launch_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == ref.shape
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), err


@pytest.mark.parametrize("hq,hkv,s", [(16, 4, 512), (8, 8, 500)],
                         ids=["gqa", "ragged"])
def test_each_backward_kernel_matches_its_plain_version(card, hq, hkv, s):
    """The dQ and the dK/dV kernel, each launched alone, against its own
    plain version on the same bf16 inputs (one bf16 ulp of the largest
    value); each launch counts its own kernel and nothing else."""
    rs = np.random.RandomState(8)
    q, do = (_randn(rs, 1, hq, s, 128).to(card, torch.bfloat16)
             for _ in range(2))
    k, v = (_randn(rs, 1, hkv, s, 128).to(card, torch.bfloat16)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, True)
    args = (q, k, v, do, lse, _bwd_delta(o, do), True)
    for name, launch, plain in (
            ("flash_attention_bwd_dq", _launch_bwd_dq,
             flash_attention_bwd_dq_reference),
            ("flash_attention_bwd_dkv", _launch_bwd_dkv,
             flash_attention_bwd_dkv_reference)):
        before = _cuda_common.launch_counts()
        got, want = launch(*args), plain(*args)
        torch.cuda.synchronize()
        after = _cuda_common.launch_counts()
        assert {n: c - before[n] for n, c in after.items() if c != before[n]} \
            == {name: 1}
        if name == "flash_attention_bwd_dq":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            err = (g.float() - w.float()).abs().max().item()
            assert err <= 2 ** -7 * w.float().abs().max().item(), (name, err)


def test_flash_attention_op_on_card_matches_autograd_of_plain(card):
    """Gradients of the differentiable op (K1 forward, K2 backward) equal
    autograd through the plain forward, in f32; under no_grad the op is
    the forward kernel alone."""
    rs = np.random.RandomState(6)
    q, k, v = (_randn(rs, 2, h, 200, 64).to(card).requires_grad_()
               for h in (8, 2, 2))
    do = _randn(rs, 2, 8, 200, 64).to(card)
    _cuda_common.reset_launch_counts()
    o, _ = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(o, (q, k, v), do)
    ro, _ = flash_attention_reference(q, k, v, True)
    want = torch.autograd.grad(ro, (q, k, v), do)
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err
    counts = _cuda_common.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    with torch.no_grad():
        o2, _ = flash_attention(q, k, v, causal=True)
    assert o2.grad_fn is None
    assert _cuda_common.launch_counts()["flash_attention_fwd"] == 2
    assert _cuda_common.launch_counts()["flash_attention_bwd_dq"] == 1


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,hq,hkv,d,bs,pages,blocks", [
    (8, 16, 16, 128, 16, 64, 600), (5, 16, 2, 64, 8, 20, 120),
    (3, 8, 1, 32, 32, 3, 12)])
def test_paged_decode_kernel_matches_plain(card, dtype, tol, s, hq, hkv, d,
                                           bs, pages, blocks):
    rs = np.random.RandomState(1)
    q = _randn(rs, s, hq, d).to(card, dtype)
    kc = _randn(rs, blocks, hkv, bs, d).to(card, dtype)
    vc = _randn(rs, blocks, hkv, bs, d).to(card, dtype)
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = ids.reshape(s, pages).astype("int32")
    lens = rs.randint(1, pages * bs + 1, (s,)).astype("int32")
    lens[0] = 1
    tables[-1, (lens[-1] - 1) // bs + 1:] = -1      # padding past the end
    tables = torch.from_numpy(tables).to(card)
    lens = torch.from_numpy(lens).to(card)
    out = paged_decode_attention(q, kc, vc, tables, lens)
    ref = paged_decode_attention_reference(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,hq,hkv,d,bs,pages,blocks", [
    (8, 16, 16, 128, 16, 64, 600), (5, 16, 2, 64, 16, 20, 120),
    (3, 8, 1, 32, 32, 3, 12)])
def test_quantized_paged_decode_kernel_matches_plain(card, fmt, dtype, tol,
                                                     s, hq, hkv, d, bs,
                                                     pages, blocks):
    rs = np.random.RandomState(2)
    q = _randn(rs, s, hq, d).to(card, dtype)
    rows, lo, smax = (bs // 2, -128, 0.3) if fmt == "int4" \
        else (bs, -127, 0.015)
    kc, vc = (torch.from_numpy(rs.randint(lo, 128, (blocks, hkv, rows, d))
                               .astype(np.int8)).to(card) for _ in range(2))
    ks, vs = (torch.from_numpy((rs.rand(blocks) * smax / 2 + smax / 2)
                               .astype("float32")).to(card)
              for _ in range(2))
    ids = rs.choice(np.arange(1, blocks), (s * pages,), replace=False)
    tables = ids.reshape(s, pages).astype("int32")
    lens = rs.randint(1, pages * bs + 1, (s,)).astype("int32")
    lens[0] = 1
    tables[-1, (lens[-1] - 1) // bs + 1:] = -1      # padding past the end
    tables = torch.from_numpy(tables).to(card)
    lens = torch.from_numpy(lens).to(card)
    name = KERNEL_NAMES[fmt]
    before = _cuda_common.launch_counts()[name]
    args = (q, kc, vc, tables, lens, ks, vs)
    out = paged_decode_attention(*args, kv_int4=fmt == "int4")
    ref = paged_decode_attention_reference(*args, kv_int4=fmt == "int4")
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()[name] == before + 1
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 5504, 2048),
                                   (2, 2048, 5504), (1, 2048, 32000),
                                   (512, 2048, 5504), (3, 64, 96),
                                   (17, 34, 32)])
def test_quant_matmul_kernel_matches_plain(card, dtype, tol, m, k, n):
    rs = np.random.RandomState(3)
    x = _randn(rs, m, k).to(card, dtype)
    packed, scale = quantize_int4(_randn(rs, k, n) * 0.05)
    packed, scale = packed.to(card), scale.to(card)
    before = _cuda_common.launch_counts()["quant_matmul"]
    out = quant_matmul_raw(x, packed, scale, k)
    ref = quant_matmul_reference(x, packed, scale, k)
    torch.cuda.synchronize()
    assert _cuda_common.launch_counts()["quant_matmul"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (m, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_quant_matmul_refuses_what_it_does_not_take(card):
    rs = np.random.RandomState(4)
    packed, scale = quantize_int4(_randn(rs, 33, 64))     # odd K
    with pytest.raises(ValueError, match="even K"):
        quant_matmul_raw(torch.zeros(2, 33, device=card), packed.to(card),
                         scale.to(card), 33)
    packed, scale = quantize_int4(_randn(rs, 64, 48))     # N % 32
    with pytest.raises(ValueError, match="multiple of 32"):
        quant_matmul_raw(torch.zeros(2, 64, device=card), packed.to(card),
                         scale.to(card), 64)
    packed, scale = quantize_int4(_randn(rs, 64, 64))
    with pytest.raises(ValueError, match="dtype"):
        quant_matmul_raw(torch.zeros(2, 64, device=card,
                                     dtype=torch.float16),
                         packed.to(card), scale.to(card), 64)
    packed, scale = quantize_int4(_randn(rs, 64, 64), group_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quant_matmul(torch.zeros(2, 64, device=card), packed.to(card),
                     scale.to(card))


def test_kernels_refuse_bad_inputs(card):
    q = torch.zeros(1, 2, 8, 16, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=card)
    lse = torch.zeros(1, 2, 8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, q, q, q, lse, q.transpose(2, 3).contiguous()
                            .transpose(2, 3))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, lse.double(), q)
    qd = torch.zeros(2, 4, 16, device=card)
    kc = torch.zeros(4, 4, 8, 16, device=card)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(qd, kc, kc,
                               torch.zeros(2, 2, dtype=torch.int64,
                                           device=card),
                               torch.ones(2, dtype=torch.int32, device=card))


def test_engine_on_card_matches_cpu_engine(card):
    """Greedy tokens of a tiny f32 model served through both kernels on
    the card equal those of the same model on the CPU (plain versions)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    stream = [(rs.randint(0, 256, (ln,)), nt)
              for ln, nt in ((3, 4), (20, 6), (2, 9), (40, 3), (4, 5))]
    out = []
    _cuda_common.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev)
        for p, nt in stream:
            eng.add_request(p, max_new_tokens=nt)
        out.append(eng.run())
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    counts = _cuda_common.launch_counts()
    assert counts["flash_attention_fwd"] == len(stream) * cfg.num_hidden_layers
    assert counts["paged_decode_attention"] > 0
    assert counts["flash_attention_bwd_dq"] == 0


def test_train_steps_on_card_match_cpu(card):
    """Five AdamW steps of a tiny f32 LLaMA on the card (K1 forward, K2
    backward) give the losses of the same steps on the CPU (plain
    versions) within 1e-4 relative, and K1/K2 launch once per layer and
    step."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    ids = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (2, 70)))
    losses = []
    for dev in ("cpu", card):
        torch.manual_seed(0)
        model = LlamaForCausalLM(cfg, device="cpu").to(dev)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        _cuda_common.reset_launch_counts()
        run = []
        for _ in range(5):
            loss = model(ids.to(dev), labels=ids.to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(loss.item())
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = _cuda_common.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == 5 * cfg.num_hidden_layers, counts


@pytest.mark.parametrize("weight_quant,kv_cache_dtype", [("int4", "int4"),
                                                         ("int8", "int8")])
def test_quantized_engine_on_card_matches_cpu_engine(card, weight_quant,
                                                     kv_cache_dtype):
    """Greedy tokens of a tiny f32 model served with quantized weights
    and KV cache through the kernels on the card equal those of the same
    model on the CPU (plain versions)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    torch.manual_seed(0)
    cfg = llama_tiny_config(num_key_value_heads=2)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    stream = [(rs.randint(0, 256, (ln,)), nt)
              for ln, nt in ((3, 4), (20, 6), (2, 9), (40, 3), (4, 5))]
    out = []
    _cuda_common.reset_launch_counts()
    for model, dev in ((cpu, "cpu"), (gpu, card)):
        eng = ServingEngine(model, max_slots=2, kv_block_size=8, device=dev,
                            weight_quant=weight_quant,
                            kv_cache_dtype=kv_cache_dtype)
        for p, nt in stream:
            eng.add_request(p, max_new_tokens=nt)
        out.append(eng.run())
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in out[1].items()}
    counts = _cuda_common.launch_counts()
    assert counts[KERNEL_NAMES[kv_cache_dtype]] > 0
    assert counts["paged_decode_attention"] == 0
    assert (counts["quant_matmul"] > 0) == (weight_quant == "int4")
