"""Transformer layers: MultiHeadAttention (with `Cache` / `StaticCache`),
the encoder and decoder layers and stacks, and Transformer.

Port of paddle_tpu/nn/layer/transformer.py. Attention runs through
`nn.functional.scaled_dot_product_attention` on [B, S, H, D]: with no
mask and no attention dropout (eval, or `attn_dropout=0`) it is the flash
op (K1 forward, K2 backward on CUDA), as the reference's gate sends it to
its Pallas kernel; the norms through `nn.LayerNorm` (K3-LN with the flag
on). `need_weights` computes the weights by the composition, as the
reference's.
"""
from __future__ import annotations

import collections
import copy
import math

import numpy as np

from ...ops.creation import full, triu, zeros
from ...ops.linalg import matmul
from ...ops.manipulation import concat, reshape, transpose
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    """query [batch, seq, embed]. The cache protocol is the reference's:
    `Cache` holds the growing projected k / v of decoder self-attention,
    `StaticCache` the fixed ones of the encoder memory; both hold [B, S,
    H, D] tensors."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return reshape(x, [b, s, self.num_heads, self.head_dim])

    def compute_kv(self, key, value):
        return (self._split_heads(self.k_proj(key)),
                self._split_heads(self.v_proj(value)))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        out_cache = None
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
            out_cache = cache
        else:
            k, v = self.compute_kv(key, value)
            if cache is not None:
                k = concat([cache[0], k], axis=1)
                v = concat([cache[1], v], axis=1)
                out_cache = MultiHeadAttention.Cache(k, v)
        if self.need_weights:
            qh = transpose(q, [0, 2, 1, 3])
            kh = transpose(k, [0, 2, 1, 3])
            vh = transpose(v, [0, 2, 1, 3])
            scores = matmul(qh, kh, transpose_y=True) * \
                (1.0 / math.sqrt(self.head_dim))
            if attn_mask is not None:
                scores = scores + attn_mask
            weights = F.softmax(scores, axis=-1)
            out = transpose(matmul(weights, vh), [0, 2, 1, 3])
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                is_causal=False, training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(reshape(out, [b, s, self.embed_dim]))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(out_cache)
        return out if len(outs) == 1 else tuple(outs)

    def gen_cache(self, key, value=None, type=None):
        if type is MultiHeadAttention.StaticCache:
            return MultiHeadAttention.StaticCache(
                *self.compute_kv(key, key if value is None else value))
        if value is not None:
            return MultiHeadAttention.Cache(key, value)
        b = key.shape[0]
        return MultiHeadAttention.Cache(
            zeros([b, 0, self.num_heads, self.head_dim], dtype=key.dtype),
            zeros([b, 0, self.num_heads, self.head_dim], dtype=key.dtype))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, new_cache = self.self_attn(src, src, src, attn_mask=src_mask,
                                            cache=cache)
        else:
            src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, new_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, nc = layer(out, src_mask=src_mask, cache=cache[i])
                new_caches.append(nc)
            else:
                out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        adrop = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, adrop,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, adrop,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        inc_cache, static_cache = cache if cache is not None else (None,
                                                                   None)
        new_inc = None
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if inc_cache is not None:
            tgt, new_inc = self.self_attn(tgt, attn_mask=tgt_mask,
                                          cache=inc_cache)
        else:
            tgt = self.self_attn(tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is not None:
            tgt, _ = self.cross_attn(tgt, memory, memory,
                                     attn_mask=memory_mask,
                                     cache=static_cache)
        else:
            tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_inc, static_cache))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, nc = layer(out, memory, tgt_mask=tgt_mask,
                                memory_mask=memory_mask, cache=cache[i])
                new_caches.append(nc)
            else:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.encoder = TransformerEncoder(
                enc, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.decoder = TransformerDecoder(
                dec, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        m = full([length, length], float(np.finfo(np.float32).min),
                 dtype="float32")
        return triu(m, diagonal=1)


def _clone_layer(layer):
    """A copy of `layer` with fresh parameters (Paddle deep-copies; the
    reference redraws every matrix by XavierNormal so stacked layers do
    not share their init)."""
    from ..initializer import XavierNormal

    new = copy.deepcopy(layer)
    for _, p in new.named_parameters():
        if p.ndim >= 2:
            XavierNormal()(p)
    return new
