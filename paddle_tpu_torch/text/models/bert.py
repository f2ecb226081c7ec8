"""BERT encoder and its sequence classifier as `nn.Layer`s.

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
LayerNorms', and the forward runs under AMP's O2 rule for the layers'
ops (`amp.model_forward`, with `auto_cast` on or off), as the
reference's autocast casts each op: every LayerNorm (BLACK_LIST) reads
its input as it comes and writes f32 with f32 weights; the projections
read their input in bf16; each dropout + add runs in bf16, the f32
residual (the previous norm's output) rounded to bf16 first; the
embeddings' dropout runs in bf16; the loss's logits are f32.

The layers are the reference's (`nn.Embedding`, `nn.LayerNorm`,
`nn.Linear` with [in, out] weights and biases, `nn.Dropout`, `encoder`
an `nn.LayerList`), so `state_dict` is the reference's; forwards take and
return the Tensor API's `Tensor` (or torch tensors) and call their
layers on the torch tensors beneath.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import nn
from ...amp import cast_for, model_forward
from ...core.dispatch import boundary
from ...nn import functional as PF
from . import _layers as L


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


class BertEmbeddings(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.layer_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    @boundary
    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)

    @boundary
    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        x = cast_for("linear", x)      # once for the three projections
        q, k, v = (lin(x).reshape(b, s, self.num_heads, self.head_dim)
                   for lin in (self.query, self.key, self.value))
        if attn_mask is not None and attn_mask.is_floating_point():
            attn_mask = attn_mask.to(q.dtype)
        o = PF.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        return self.out(o.reshape(b, s, h))


class BertLayer(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.attention = BertSelfAttention(config)
        self.attn_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.intermediate = nn.Linear(h, config.intermediate_size)
        self.output = nn.Linear(config.intermediate_size, h)
        self.out_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    @boundary
    def forward(self, x, attn_mask=None):
        """Post-LN: dropout(attention) + x -> attn_norm, then dropout(GELU
        MLP) + that -> out_norm; each dropout + add is one op."""
        p = self.dropout.p
        x = self.attn_norm(PF.fused_dropout_add(self.attention(x, attn_mask),
                                                x, p, self.training))
        y = self.output(PF.gelu(self.intermediate(x)))
        return self.out_norm(PF.fused_dropout_add(y, x, p, self.training))


class BertModel(nn.Layer):
    """Embeddings, encoder layers and the tanh pooler over the first
    token. Built on `device` ("cuda" unless the caller asks for another;
    no card -> RuntimeError) in `dtype`, its initial weights from a seed
    that torch's default generator gives."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        with L.built_on(device):
            self.embeddings = BertEmbeddings(config)
            self.encoder = nn.LayerList(
                [BertLayer(config) for _ in range(config.num_hidden_layers)])
            self.pooler = nn.Linear(config.hidden_size, config.hidden_size)
        L.cast_floating(self, dtype)

    @property
    def device(self) -> torch.device:
        return self.pooler.weight._data.device

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
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForSequenceClassification(nn.Layer):
    """BertModel, dropout and a linear classifier over the pooled output;
    with labels, the mean cross-entropy of the f32 logits."""

    def __init__(self, config: BertConfig, num_classes=2, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.bert = BertModel(config, device=device, dtype=dtype)
        with L.built_on(self.bert.device):
            self.dropout = nn.Dropout(config.hidden_dropout_prob)
            self.classifier = nn.Linear(config.hidden_size, num_classes)
        L.cast_floating(self.classifier, dtype)

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
