"""LLaMA-family decoder as `nn.Layer`s — dense, single device.

Port of paddle_tpu/text/models/llama.py (config, rope tables, attention,
SwiGLU MLP, decoder layer, model, causal-LM head and its loss) with the
reference's activation recompute (`use_recompute`, at the granularities
"full", "mlp" and "flash_resident"; see `LlamaModel.forward`). Out of
scope here: tensor/sequence parallelism (their config switches raise
`NotImplementedError` naming the ROADMAP item), fp8 and the pipeline
layer descriptions.

The layers are the reference's: `nn.Linear(bias_attr=False)` (weights
[in, out]), `nn.Embedding`, `nn.RMSNorm`, and the model is reachable as
both `llama` and `model`, so `state_dict` has the reference's keys
(`llama.*`), shapes and dtypes and a checkpoint of either package loads
in the other through `set_state_dict`. The rope tables are
non-persistable buffers of `LlamaModel`, out of the state dict as there.
Forwards take and return the Tensor API's `Tensor` (or torch tensors)
and call their layers on the torch tensors beneath.

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

Mixed precision (`amp.decorate` O2): parameters are bf16, and the
forward runs under AMP's O2 rule for the layers' ops (`amp.model_forward`,
with `auto_cast` on or off): every matmul runs in bf16; the input and
final norms write f32 (`rms_norm` is on the BLACK_LIST) and the
projections after them read their input in bf16; the fused add+norm,
rotary and SwiGLU run in bf16, as in the reference; the logits of the
loss and the cross-entropy are computed in f32. With the flag off the
blocks' norms are the composition's (`_rms_norm`, the stream's dtype).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import nn
from ...amp import cast_for, model_forward
from ...core.dispatch import boundary
from ...core.flags import flag
from ...core.tensor import Tensor
from ...distributed.fleet.utils import recompute
from ...incubate.nn.functional import fused_linear_cross_entropy
from ...nn import functional as PF
from ...ops.flash_attention import flash_attention
from ..generation import (_attention_block, _layer_forward_prefill,
                          _layer_weights, _mlp_block, _rope_tables,
                          _spec_from_config)
from . import _layers as L


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
    # the reference's parallelism switches; not ported yet (switched on,
    # building the model raises NotImplementedError)
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    # activation recompute: "full" | "mlp" | "flash_resident" (any other
    # granularity runs the layers plainly, as the reference's)
    use_recompute: bool = False
    recompute_granularity: str = "full"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_7b_config(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128)
    base.update(kw)
    return LlamaConfig(**base)


class LlamaAttention(nn.Layer):
    """q/k/v/o projections; `forward` is the flag-on attention block (the
    flag-off path reads the parameters into `_layer_forward_prefill`)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        self.num_heads, self.num_kv_heads, self.head_dim = nh, nkv, hd
        self.q_proj = nn.Linear(h, nh * hd, bias_attr=False)
        self.k_proj = nn.Linear(h, nkv * hd, bias_attr=False)
        self.v_proj = nn.Linear(h, nkv * hd, bias_attr=False)
        self.o_proj = nn.Linear(nh * hd, h, bias_attr=False)

    @boundary
    def forward(self, x, cos, sin):
        """x [B, S, H] (the input norm's output, cast once for the three
        projections); cos/sin [>=S, D] -> [B, S, H]."""
        b, s, _ = x.shape
        x = cast_for("linear", x)
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


class LlamaMLP(nn.Layer):
    """SwiGLU projections; `forward` is the flag-on MLP block."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias_attr=False)
        self.up_proj = nn.Linear(h, i, bias_attr=False)
        self.down_proj = nn.Linear(i, h, bias_attr=False)

    @boundary
    def forward(self, x):
        x = cast_for("linear", x)
        return self.down_proj(PF.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Layer):
    """One block. With `use_recompute` at granularity "mlp" it keeps the
    attention half's activations and recomputes the MLP half
    (`_mlp_branch`) in the backward, as the reference's "mlp" branch
    does; the residual add is then a plain add, not the fused add+norm,
    the same math."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.spec = _spec_from_config(config)
        self.recompute_mlp = (config.use_recompute
                              and config.recompute_granularity == "mlp")
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          epsilon=config.rms_norm_eps)
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps)

    @boundary
    def forward(self, x, cos, sin):
        fused = flag("FLAGS_pallas_fused_ops")
        if self.recompute_mlp:
            if fused:
                x = x + self.self_attn(self.input_layernorm(x), cos, sin)
            else:
                x = _attention_block(x, _layer_weights(self), self.spec, cos,
                                     sin)[0]
            return x + recompute(self._mlp_branch, x)
        if not fused:
            return _layer_forward_prefill(x, _layer_weights(self), self.spec,
                                          cos, sin)[0]
        a = self.self_attn(self.input_layernorm(x), cos, sin)
        y, x = self.post_attention_layernorm.forward_fused_add(a, x)
        return x + self.mlp(y)

    def _mlp_branch(self, x):
        """mlp(post_attention_layernorm(x)) with the flag on; with it off,
        `_mlp_block`'s compositions."""
        if not flag("FLAGS_pallas_fused_ops"):
            return _mlp_block(x, _layer_weights(self), self.spec)
        return self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Layer):
    """Embedding, decoder layers and the final norm, on the Tensor API's
    current device (`LlamaForCausalLM` builds it on its `device`)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = nn.RMSNorm(config.hidden_size,
                               epsilon=config.rms_norm_eps)
        # shared by every layer; not part of the state dict
        cos, sin = _rope_tables(config, torch.float32,
                                self.norm.weight._data.device)
        self.register_buffer("rope_cos", Tensor._wrap(cos),
                             persistable=False)
        self.register_buffer("rope_sin", Tensor._wrap(sin),
                             persistable=False)

    @boundary
    @model_forward
    def forward(self, input_ids):
        """[B, S] ids -> the final norm's output [B, S, H] (f32 under
        O2's rule, see the module docstring). With `use_recompute`, as
        the reference's: "full" wraps each
        layer in `recompute` (its backward runs the whole layer again, K1
        included); "flash_resident" too, with the policy that keeps the
        flash forward's o and lse (the backward reruns everything but
        K1); any other granularity, "mlp" among them, calls the layer,
        which handles "mlp" itself."""
        cfg = self.config
        gran = cfg.recompute_granularity if cfg.use_recompute else None
        cos, sin = self.rope_cos._data, self.rope_sin._data
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            if gran == "full":
                x = recompute(layer, x, cos, sin)
            elif gran == "flash_resident":
                x = recompute(layer, x, cos, sin, policy="flash_resident")
            else:
                x = layer(x, cos, sin)
        return self.norm(x)


#: config switches the port does not implement yet -> the ROADMAP item
_UNPORTED = {
    "tensor_parallel": "ROADMAP 'After these', Distributed",
    "sequence_parallel": "ROADMAP 'After these', Distributed",
}


class LlamaForCausalLM(nn.Layer):
    """LLaMA with its LM head. Built on `device` ("cuda" unless the caller
    asks for another; no card -> RuntimeError) in `dtype`, with the
    reference's initializers drawn from a seed that torch's default
    generator gives (seed it with `torch.manual_seed` or `paddle.seed`).
    `forward` trains (with labels it returns the loss; attention is the
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
        self.config = config
        with L.built_on(device):
            self.llama = self.model = LlamaModel(config)
            self.lm_head = None if config.tie_word_embeddings else \
                nn.Linear(config.hidden_size, config.vocab_size,
                          bias_attr=False)
        L.cast_floating(self, dtype)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight._data.device

    def rope_tables(self):
        return self.model.rope_cos._data, self.model.rope_sin._data

    @boundary
    @model_forward
    def forward(self, input_ids, labels=None):
        """input_ids [B, S] (tensor or array) -> logits [B, S, V] in the
        model's dtype; with `labels` [B, S], the mean causal-LM
        cross-entropy in f32 instead, over the labels that are not -100
        (no shift: the caller aligns them, as the reference's train step
        passes `model(x, x)`). An lm_head with vocab >= 4096 takes
        `fused_linear_cross_entropy` on its [H, V] weight, the reference's
        branch; smaller vocabs (and tied embeddings) the plain
        cross-entropy of the f32 logits. A tied head reads the final
        norm's output in the embeddings' dtype."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        hidden = self.model(ids)
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device).long()
            if self.lm_head is not None and self.config.vocab_size >= 4096:
                return fused_linear_cross_entropy(
                    hidden, self.lm_head.weight._data, labels)
        if self.lm_head is None:
            emb = self.model.embed_tokens.weight._data
            logits = hidden.to(emb.dtype) @ emb.T
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
        """Autoregressive decoding; returns int64 tokens [B, prompt_len +
        n_generated] on the CPU. engine="static" (the default) runs the
        single-program engine (a prefill, then one captured decode step
        replayed), engine="paged" the continuous-batching ServingEngine
        (inference/engine.py); `spec_decode` speculates (text/
        generation.py `generate`)."""
        from ..generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         max_length=max_length, do_sample=do_sample,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         eos_token_id=eos_token_id, seed=seed,
                         weight_quant=weight_quant, engine=engine,
                         prefix_cache=prefix_cache, spec_decode=spec_decode)
