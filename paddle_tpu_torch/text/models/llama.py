"""LLaMA-family decoder as torch `nn.Module`s — dense, single device.

Port of paddle_tpu/text/models/llama.py (config, rope tables, attention,
SwiGLU MLP, decoder layer, model, causal-LM head and its loss). Out of
scope here: tensor/sequence parallelism and recompute (their config
switches raise `NotImplementedError` naming the ROADMAP item), fp8 and
the pipeline layer descriptions.

The forward follows `FLAGS_pallas_fused_ops`, as the reference's does.
On (the default): the reference's module structure — `input_layernorm`,
q/k/v, `F.rotary_position_embedding`, the flash op, o_proj,
`post_attention_layernorm.forward_fused_add` (residual add fused into the
norm), `F.swiglu`, and the final `norm` — whose norms, rotary and SwiGLU
are the fused ops of `ops.fused_norm` (K3, K4, K5 on CUDA; K4 only when
Q and K have one shape, so not under GQA). Off: the block math is
`text.generation._layer_forward_prefill`, the plain compositions the
serving engine's prefill runs. Attention on both goes through the
differentiable flash op (`ops.flash_attention.flash_attention`): K1
forward and, when a gradient is recorded, K2 backward on CUDA; their
plain versions on the CPU. The serving engine never runs this forward.

Mixed precision (`amp.decorate` O2): parameters are bf16 and every matmul
runs in bf16; the logits of the loss and the cross-entropy are computed
in f32, the ops the reference's AMP keeps in f32. With the flag on, the
input and final norms write f32 (the reference's O2 runs `rms_norm`, a
BLACK_LIST op, in f32) and the matmuls after them read their input in
the weights' dtype, as the reference's autocast casts it; the fused
add+norm, rotary and SwiGLU run in bf16, as there. With the flag off the
norms write the stream's dtype (the composition's `_rms_norm`).

Linear weights use torch's [out, in] layout (paddle_tpu's Linear stores
[in, out]; `convert.llama_from_numpy` transposes on the way in).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...core.flags import flag
from ...incubate.nn.functional import fused_linear_cross_entropy
from ...nn import functional as PF
from ...ops._cuda_common import resolve_device
from ...ops.flash_attention import flash_attention
from ..generation import (_layer_forward_prefill, _layer_weights,
                          _rope_tables, _spec_from_config)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # the reference's parallelism and recompute switches; not ported yet
    # (switched on, building the model raises NotImplementedError)
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    use_recompute: bool = False
    recompute_granularity: str = "full"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128)
    base.update(kw)
    return LlamaConfig(**base)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size, eps, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, **factory))

    def forward(self, x, out_dtype=None):
        """`nn.functional.rms_norm` (K3 when the flag is on);
        `out_dtype=torch.float32` as the reference's O2 runs it."""
        return PF.rms_norm(x, self.weight, self.eps, out_dtype)

    def forward_fused_add(self, x, residual):
        """(normed, summed) = (norm(x + residual), x + residual) by
        `nn.functional.fused_add_rms_norm` (one K3 launch when the flag is
        on)."""
        return PF.fused_add_rms_norm(x, residual, self.weight, self.eps)


class LlamaAttention(nn.Module):
    """q/k/v/o projections; `forward` is the flag-on attention block (the
    flag-off path reads the parameters into `_layer_forward_prefill`)."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        self.num_heads, self.num_kv_heads, self.head_dim = nh, nkv, hd
        self.q_proj = nn.Linear(h, nh * hd, bias=False, **factory)
        self.k_proj = nn.Linear(h, nkv * hd, bias=False, **factory)
        self.v_proj = nn.Linear(h, nkv * hd, bias=False, **factory)
        self.o_proj = nn.Linear(nh * hd, h, bias=False, **factory)

    def forward(self, x, cos, sin):
        """x [B, S, H] (the input norm's output, read in the weights'
        dtype); cos/sin [>=S, D] -> [B, S, H]."""
        b, s, _ = x.shape
        x = x.to(self.q_proj.weight.dtype)
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = PF.rotary_position_embedding(q, k, cos[None, :s, None, :],
                                            sin[None, :s, None, :])
        out, _ = flash_attention(q.transpose(1, 2).contiguous(),
                                 k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), causal=True)
        return self.o_proj(out.transpose(1, 2).reshape(
            b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU projections; `forward` is the flag-on MLP block."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, **factory)
        self.up_proj = nn.Linear(h, i, bias=False, **factory)
        self.down_proj = nn.Linear(i, h, bias=False, **factory)

    def forward(self, x):
        return self.down_proj(PF.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.spec = _spec_from_config(config)
        self.self_attn = LlamaAttention(config, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            config.rms_norm_eps, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, **factory)

    def forward(self, x, cos, sin):
        if not flag("FLAGS_pallas_fused_ops"):
            return _layer_forward_prefill(x, _layer_weights(self), self.spec,
                                          cos, sin)[0]
        a = self.self_attn(self.input_layernorm(x, torch.float32), cos, sin)
        y, x = self.post_attention_layernorm.forward_fused_add(a, x)
        return x + self.mlp(y)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 **factory)
        # shared by every layer; not part of the state dict
        cos, sin = _rope_tables(config, factory["dtype"], factory["device"])
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids):
        """[B, S] ids -> the final norm's output [B, S, H]: f32 with the
        flag on (see the module docstring), the stream's dtype with it
        off."""
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, self.rope_cos, self.rope_sin)
        return self.norm(x, torch.float32 if flag("FLAGS_pallas_fused_ops")
                         else None)


#: config switches the port does not implement yet -> the ROADMAP item
_UNPORTED = {
    "use_recompute": "ROADMAP Queue 1 item 1b (recompute)",
    "tensor_parallel": "ROADMAP 'After these', Distributed",
    "sequence_parallel": "ROADMAP 'After these', Distributed",
}


class LlamaForCausalLM(nn.Module):
    """LLaMA with its LM head. Built on `device` ("cuda" unless the caller
    asks for another; no card -> RuntimeError) in `dtype`, with torch's
    default random init (seed it with `torch.manual_seed`). `forward`
    trains (with labels it returns the loss; attention is the
    differentiable flash op) and gives logits; `generate` serves through
    the paged engine under `torch.no_grad()`."""

    _gen_arch = "llama"

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        for name, item in _UNPORTED.items():
            if getattr(config, name):
                raise NotImplementedError(
                    f"LlamaConfig.{name}=True is not ported yet ({item})")
        factory = {"device": resolve_device(device), "dtype": dtype}
        self.config = config
        self.model = LlamaModel(config, **factory)
        self.lm_head = None if config.tie_word_embeddings else nn.Linear(
            config.hidden_size, config.vocab_size, bias=False, **factory)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def rope_tables(self):
        return self.model.rope_cos, self.model.rope_sin

    def forward(self, input_ids, labels=None):
        """input_ids [B, S] (tensor or array) -> logits [B, S, V] in the
        model's dtype; with `labels` [B, S], the mean causal-LM
        cross-entropy in f32 instead, over the labels that are not -100
        (no shift: the caller aligns them, as the reference's train step
        passes `model(x, x)`). An lm_head with vocab >= 4096 takes
        `fused_linear_cross_entropy`, the reference's branch; smaller
        vocabs (and tied embeddings) the plain cross-entropy of the f32
        logits. The head reads the final norm's output in the parameters'
        dtype."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        hidden = self.model(ids).to(self.model.embed_tokens.weight.dtype)
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device).long()
            if self.lm_head is not None and self.config.vocab_size >= 4096:
                return fused_linear_cross_entropy(
                    hidden, self.lm_head.weight.T, labels)
        if self.lm_head is None:
            logits = hidden @ self.model.embed_tokens.weight.T
        else:
            logits = self.lm_head(hidden)
        if labels is None:
            return logits
        return F.cross_entropy(
            logits.float().reshape(-1, self.config.vocab_size),
            labels.reshape(-1), ignore_index=-100)

    def generate(self, input_ids, max_new_tokens=32, max_length=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 eos_token_id=None, seed=None, weight_quant="none",
                 engine="static", prefix_cache=None, spec_decode=None):
        """Autoregressive decoding. engine="paged" runs the
        continuous-batching ServingEngine (inference/engine.py) and returns
        int64 tokens [B, prompt_len + n_generated] on the CPU. The static
        single-program engine is not ported yet."""
        from ..generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         max_length=max_length, do_sample=do_sample,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         eos_token_id=eos_token_id, seed=seed,
                         weight_quant=weight_quant, engine=engine,
                         prefix_cache=prefix_cache, spec_decode=spec_decode)
