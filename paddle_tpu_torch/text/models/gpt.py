"""GPT decoder (GPT-2/3 style) as `nn.Layer`s — dense, single device.

Port of paddle_tpu/text/models/gpt.py (`GPTConfig`, `GPTAttention`,
`GPTBlock`, `GPTForCausalLM`): learned positions, pre-norm LayerNorm
blocks with a fused qkv projection, a GELU MLP, no biases in the
projections. Out of scope here: tensor/sequence parallelism (their config
switches raise `NotImplementedError` naming the ROADMAP entry) and
`generate` (GPT serving, ROADMAP Queue 1 item 10).

The forward follows `FLAGS_pallas_fused_ops`, as the reference's does:
on, `ln_1`, `ln_2.forward_fused_add` (the residual add fused into the
norm) and `ln_f` are K3-LN on CUDA (its plain version on the CPU); off,
the reference's compositions. Attention is `nn.functional.
scaled_dot_product_attention` (causal): the flash op, K1 forward and K2
backward on CUDA.

Mixed precision (`amp.decorate` O2): parameters are bf16 except the
LayerNorms', which stay f32, and the forward runs under AMP's O2 rule
for the layers' ops (`amp.model_forward`, with `auto_cast` on or off),
as the reference's autocast casts each op: `ln_1` and `ln_f` (BLACK_LIST
`layer_norm`) read the bf16 stream and write f32 with f32 weights; every
projection reads its input in bf16; `ln_2`'s fused add + norm runs in
bf16, its f32 weight and bias rounded to bf16 first; the loss's logits
are f32.

The layers are the reference's (`nn.Embedding` `wte` / `wpe`, `nn.LayerNorm`,
`nn.Linear(bias_attr=False)` with [in, out] weights, `blocks` an
`nn.LayerList`), so `state_dict` is the reference's; forwards take and
return the Tensor API's `Tensor` (or torch tensors) and call their
layers on the torch tensors beneath.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import nn
from ...amp import model_forward
from ...core.dispatch import boundary
from ...incubate.nn.functional import fused_linear_cross_entropy
from ...nn import functional as PF
from . import _layers as L


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024          # GPT-3 medium
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int | None = None
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    # the reference's parallelism switches; not ported yet (switched on,
    # building the model raises NotImplementedError)
    tensor_parallel: bool = False
    sequence_parallel: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


class GPTAttention(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.qkv_proj = nn.Linear(h, 3 * h, bias_attr=False)
        self.out_proj = nn.Linear(h, h, bias_attr=False)

    @boundary
    def forward(self, x):
        """x [B, S, H] -> [B, S, H]: fused qkv reshaped [B, S, 3, heads,
        head_dim], causal attention."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        o = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(o.reshape(b, s, h))


class GPTBlock(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.ln_1 = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.attn = GPTAttention(config)
        self.ln_2 = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.fc_in = nn.Linear(h, i, bias_attr=False)
        self.fc_out = nn.Linear(i, h, bias_attr=False)

    @boundary
    def forward(self, x):
        a = self.attn(self.ln_1(x))
        y, x = self.ln_2.forward_fused_add(a, x)
        return x + self.fc_out(PF.gelu(self.fc_in(y)))


#: config switches the port does not implement yet -> the ROADMAP item
_UNPORTED = {
    "tensor_parallel": "ROADMAP 'After these', Distributed",
    "sequence_parallel": "ROADMAP 'After these', Distributed",
}


class GPTForCausalLM(nn.Layer):
    """GPT with its LM head. Built on `device` ("cuda" unless the caller
    asks for another; no card -> RuntimeError) in `dtype`, with the
    reference's initializers drawn from a seed that torch's default
    generator gives (seed it with `torch.manual_seed` or
    `paddle.seed`)."""

    _gen_arch = "gpt"

    def __init__(self, config: GPTConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        for name, item in _UNPORTED.items():
            if getattr(config, name):
                raise NotImplementedError(
                    f"GPTConfig.{name}=True is not ported yet ({item})")
        self.config = config
        h = config.hidden_size
        with L.built_on(device):
            self.wte = nn.Embedding(config.vocab_size, h)
            self.wpe = nn.Embedding(config.max_position_embeddings, h)
            self.blocks = nn.LayerList([GPTBlock(config) for _ in
                                        range(config.num_hidden_layers)])
            self.ln_f = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
            self.lm_head = nn.Linear(h, config.vocab_size, bias_attr=False)
        L.cast_floating(self, dtype)

    @property
    def device(self) -> torch.device:
        return self.wte.weight._data.device

    @boundary
    @model_forward
    def forward(self, input_ids, labels=None):
        """input_ids [B, S] (tensor or array) -> logits [B, S, V] in the
        head's dtype; with `labels` [B, S], the mean cross-entropy in f32
        over the labels that are not -100 (no shift, as the reference's
        bench step passes `model(x, x)`). Vocab >= 4096 takes
        `fused_linear_cross_entropy` on the head's [H, V] weight (the
        reference's branch; GPT's 50304 has no usable vocab chunk, so it
        runs by token chunks), smaller vocabs the plain cross-entropy of
        the f32 logits."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        pos = torch.arange(ids.shape[1], device=self.device)[None]
        x = self.wte(ids) + self.wpe(pos)
        for blk in self.blocks:
            x = blk(x)
        hidden = self.ln_f(x)
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device).long()
            if self.config.vocab_size >= 4096:
                return fused_linear_cross_entropy(
                    hidden, self.lm_head.weight._data, labels,
                    chunk_size=8192)
        logits = self.lm_head(hidden)
        if labels is None:
            return logits
        return F.cross_entropy(
            logits.float().reshape(-1, self.config.vocab_size),
            labels.reshape(-1), ignore_index=-100)

    def generate(self, *args, **kwargs):
        raise NotImplementedError(
            "GPTForCausalLM.generate (GPT serving: the engine's gpt arch) "
            "is not ported to paddle_tpu_torch yet (ROADMAP Queue 1, item "
            "10, 'GPT serving')")
