"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs a CUDA card (marker `cuda`) and skips without one.
The file imports neither jax nor paddle_tpu, so it runs where the port
runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` keeps tests/conftest.py, which sets up jax, out.) The
plain versions are themselves held against paddle_tpu in
test_torch_flash_attention.py / test_torch_paged_decode.py on the CPU.
Tolerances: f32 1e-4 (f32 accumulation in another order); bf16 2e-2
(bf16 output rounding of values of magnitude ~1, 2^-8 relative).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_reference)
from paddle_tpu_torch.ops.paged_decode import (
    paged_decode_attention, paged_decode_attention_reference)

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


def test_kernels_refuse_bad_inputs(card):
    q = torch.zeros(1, 2, 8, 16, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q)
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
