"""LLaMA-family decoder as torch `nn.Module`s — dense, single device.

Port of paddle_tpu/text/models/llama.py (config, rope tables, attention,
SwiGLU MLP, decoder layer, model, causal-LM head). Out of scope here:
tensor/sequence parallelism, recompute, fp8 and the pipeline layer
descriptions, and the fused lm_head + cross-entropy loss.

The attention and MLP modules hold the parameters; the block's math is
`text.generation._layer_forward_prefill`, the same function the serving
engine's prefill runs, so the model and the engine cannot drift apart.
Attention there goes through the flash kernel on CUDA and its plain
version on the CPU.

Linear weights use torch's [out, in] layout (paddle_tpu's Linear stores
[in, out]; `convert.llama_from_numpy` transposes on the way in).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...ops._cuda_common import resolve_device
from ..generation import (_layer_forward_prefill, _layer_weights, _rms_norm,
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

    def forward(self, x):
        return _rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    """q/k/v/o projections (parameters only; see the module docstring)."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        self.q_proj = nn.Linear(h, nh * hd, bias=False, **factory)
        self.k_proj = nn.Linear(h, nkv * hd, bias=False, **factory)
        self.v_proj = nn.Linear(h, nkv * hd, bias=False, **factory)
        self.o_proj = nn.Linear(nh * hd, h, bias=False, **factory)


class LlamaMLP(nn.Module):
    """SwiGLU projections (parameters only; see the module docstring)."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, **factory)
        self.up_proj = nn.Linear(h, i, bias=False, **factory)
        self.down_proj = nn.Linear(i, h, bias=False, **factory)


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
        return _layer_forward_prefill(x, _layer_weights(self), self.spec,
                                      cos, sin)[0]


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
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, self.rope_cos, self.rope_sin)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """LLaMA with its LM head. Built on `device` ("cuda" unless the caller
    asks for another; no card -> RuntimeError) in `dtype`, with torch's
    default random init (seed it with `torch.manual_seed`). Inference
    only in this slice: the attention kernel has no backward yet (K2)."""

    _gen_arch = "llama"

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
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

    def forward(self, input_ids):
        """input_ids [B, S] (tensor or array) -> logits [B, S, V] in the
        model's dtype."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        hidden = self.model(ids)
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.T
        return self.lm_head(hidden)

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
