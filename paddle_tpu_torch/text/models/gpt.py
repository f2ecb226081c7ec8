"""GPT decoder (GPT-2/3 style) as torch `nn.Module`s — dense, single device.

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
LayerNorms', which stay f32. The forward casts at each op where the
reference's O2 autocast does (`paddle_tpu/core/dispatch.py`): `ln_1` and
`ln_f` (BLACK_LIST `layer_norm`) read the bf16 stream and write f32 with
f32 weights; every projection reads its input in the weights' dtype;
`ln_2`'s fused add + norm runs in bf16, its f32 weight and bias rounded
to bf16 first (`LayerNorm.forward_fused_add`); the loss's logits are f32.

Linear weights use torch's [out, in] layout (paddle_tpu's Linear stores
[in, out]; `convert.gpt_from_numpy` transposes on the way in).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...incubate.nn.functional import fused_linear_cross_entropy
from ...nn import functional as PF
from ...nn.layer import LayerNorm
from ...ops._cuda_common import resolve_device


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


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.qkv_proj = nn.Linear(h, 3 * h, bias=False, **factory)
        self.out_proj = nn.Linear(h, h, bias=False, **factory)

    def forward(self, x):
        """x [B, S, H] (read in the weights' dtype) -> [B, S, H]: fused
        qkv reshaped [B, S, 3, heads, head_dim], causal attention."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x.to(self.qkv_proj.weight.dtype)).reshape(
            b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        o = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(o.reshape(b, s, h))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.ln_1 = LayerNorm(h, config.layer_norm_eps, **factory)
        self.attn = GPTAttention(config, **factory)
        self.ln_2 = LayerNorm(h, config.layer_norm_eps, **factory)
        self.fc_in = nn.Linear(h, i, bias=False, **factory)
        self.fc_out = nn.Linear(i, h, bias=False, **factory)

    def forward(self, x):
        a = self.attn(self.ln_1(x, torch.float32))
        y, x = self.ln_2.forward_fused_add(a, x)
        return x + self.fc_out(PF.gelu(self.fc_in(
            y.to(self.fc_in.weight.dtype))))


#: config switches the port does not implement yet -> the ROADMAP item
_UNPORTED = {
    "tensor_parallel": "ROADMAP 'After these', Distributed",
    "sequence_parallel": "ROADMAP 'After these', Distributed",
}


class GPTForCausalLM(nn.Module):
    """GPT with its LM head. Built on `device` ("cuda" unless the caller
    asks for another; no card -> RuntimeError) in `dtype`, with torch's
    default random init (seed it with `torch.manual_seed`)."""

    _gen_arch = "gpt"

    def __init__(self, config: GPTConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        for name, item in _UNPORTED.items():
            if getattr(config, name):
                raise NotImplementedError(
                    f"GPTConfig.{name}=True is not ported yet ({item})")
        factory = {"device": resolve_device(device), "dtype": dtype}
        self.config = config
        h = config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, h, **factory)
        self.wpe = nn.Embedding(config.max_position_embeddings, h, **factory)
        self.blocks = nn.ModuleList([GPTBlock(config, **factory)
                                     for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(h, config.layer_norm_eps, **factory)
        self.lm_head = nn.Linear(h, config.vocab_size, bias=False, **factory)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, input_ids, labels=None):
        """input_ids [B, S] (tensor or array) -> logits [B, S, V] in the
        head's dtype; with `labels` [B, S], the mean cross-entropy in f32
        over the labels that are not -100 (no shift, as the reference's
        bench step passes `model(x, x)`). Vocab >= 4096 takes
        `fused_linear_cross_entropy` (the reference's branch; it chunks by
        8192 tokens, the port computes the same loss unchunked), smaller
        vocabs the plain cross-entropy of the f32 logits."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        pos = torch.arange(ids.shape[1], device=self.device)[None]
        x = self.wte(ids) + self.wpe(pos)
        for blk in self.blocks:
            x = blk(x)
        hidden = self.ln_f(x, torch.float32).to(self.lm_head.weight.dtype)
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device).long()
            if self.config.vocab_size >= 4096:
                return fused_linear_cross_entropy(
                    hidden, self.lm_head.weight.T, labels, chunk_size=8192)
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
