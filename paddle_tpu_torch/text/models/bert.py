"""BERT encoder and its sequence classifier as torch `nn.Module`s.

Port of paddle_tpu/text/models/bert.py (`BertConfig`, `BertEmbeddings`,
`BertSelfAttention`, `BertLayer`, `BertModel`,
`BertForSequenceClassification`): post-LN blocks whose two residual adds
are dropout + add (`nn.functional.fused_dropout_add`: K6 on CUDA with
`FLAGS_pallas_fused_ops` on), LayerNorms (K3-LN with the flag on), a GELU
MLP and a tanh pooler. Attention is `nn.functional.
scaled_dot_product_attention`, non-causal: the flash op (K1 forward, K2
backward on CUDA) without `attn_mask`, the reference's plain composition
with one.

Dropout masks come from torch's generator (the device's default one:
seed it with `torch.manual_seed`), not from JAX's; the two packages agree
with `hidden_dropout_prob=0.0`, where both skip dropout.

Mixed precision (`amp.decorate` O2): parameters bf16 except the
LayerNorms'. The forward casts where the reference's O2 autocast does:
every LayerNorm (BLACK_LIST) reads its input as it comes and writes f32
with f32 weights; the projections read their input in the weights'
dtype; each dropout + add runs in bf16, the f32 residual (the previous
norm's output) rounded to bf16 first; the embeddings' dropout, when it
draws, runs in the embeddings' dtype; the loss's logits are f32.

Linear weights use torch's [out, in] layout (`convert.bert_from_numpy`
transposes paddle_tpu's [in, out]).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...amp import model_forward
from ...core.dispatch import boundary
from ...nn import functional as PF
from .modules import Dropout, LayerNorm
from ...ops._cuda_common import resolve_device


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **factory)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **factory)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **factory)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **factory)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        h = self.layer_norm(x, torch.float32)
        if self.training and self.dropout.p > 0.0:
            h = h.to(x.dtype)   # O2: the reference's dropout op runs in bf16
        return self.dropout(h)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.query = nn.Linear(h, h, **factory)
        self.key = nn.Linear(h, h, **factory)
        self.value = nn.Linear(h, h, **factory)
        self.out = nn.Linear(h, h, **factory)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        x = x.to(self.query.weight.dtype)
        q, k, v = (lin(x).reshape(b, s, self.num_heads, self.head_dim)
                   for lin in (self.query, self.key, self.value))
        if attn_mask is not None and attn_mask.is_floating_point():
            attn_mask = attn_mask.to(q.dtype)
        o = PF.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        return self.out(o.reshape(b, s, h))


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.attention = BertSelfAttention(config, **factory)
        self.attn_norm = LayerNorm(h, config.layer_norm_eps, **factory)
        self.intermediate = nn.Linear(h, config.intermediate_size, **factory)
        self.output = nn.Linear(config.intermediate_size, h, **factory)
        self.out_norm = LayerNorm(h, config.layer_norm_eps, **factory)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        """Post-LN: dropout(attention) + x -> attn_norm, then dropout(GELU
        MLP) + that -> out_norm; each dropout + add is one op."""
        p = self.dropout.p
        a = self.attention(x, attn_mask)
        x = self.attn_norm(PF.fused_dropout_add(a, x.to(a.dtype), p,
                                                self.training),
                           torch.float32)
        y = self.output(PF.gelu(self.intermediate(
            x.to(self.intermediate.weight.dtype))))
        return self.out_norm(PF.fused_dropout_add(y, x.to(y.dtype), p,
                                                  self.training),
                             torch.float32)


class BertModel(nn.Module):
    """Embeddings, encoder layers and the tanh pooler over the first
    token. Built on `device` ("cuda" unless the caller asks for another;
    no card -> RuntimeError) in `dtype`."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32):
        super().__init__()
        factory = {"device": resolve_device(device), "dtype": dtype}
        self.config = config
        self.embeddings = BertEmbeddings(config, **factory)
        self.encoder = nn.ModuleList(
            [BertLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                **factory)

    @property
    def device(self) -> torch.device:
        return self.pooler.weight.device

    @boundary
    @model_forward
    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        """-> (sequence output [B, S, H] in f32, the last norm's output;
        pooled [B, H] in the pooler's dtype)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if token_type_ids is not None:
            token_type_ids = torch.as_tensor(token_type_ids,
                                             device=self.device).long()
        x = self.embeddings(ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask)
        first = x[:, 0].to(self.pooler.weight.dtype)
        pooled = torch.tanh(self.pooler(first))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """BertModel, dropout and a linear classifier over the pooled output;
    with labels, the mean cross-entropy of the f32 logits."""

    def __init__(self, config: BertConfig, num_classes=2, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.bert = BertModel(config, device=device, dtype=dtype)
        factory = {"device": self.bert.device, "dtype": dtype}
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    **factory)

    @property
    def device(self) -> torch.device:
        return self.bert.device

    @boundary
    @model_forward
    def forward(self, input_ids, token_type_ids=None, labels=None,
                attn_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attn_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=self.device).long()
        return F.cross_entropy(logits.float(), labels, ignore_index=-100)
