"""Incubating functional APIs of the port."""
import math

from ....nn import functional as F
from ....nn.functional import fused_dropout_add  # noqa: F401
from .fused_loss import (fused_linear_cross_entropy,  # noqa: F401
                         fused_linear_cross_entropy_reference)


def memory_efficient_attention(query, key, value, bias=None, cu_seqlens_q=None,
                               cu_seqlens_k=None, max_seqlen_q=None,
                               max_seqlen_k=None, causal=False, dropout_p=0.0,
                               scale=None, training=True, name=None):
    """Port of paddle_tpu/incubate/nn/functional `memory_efficient_attention`
    (:659): query/key/value [B, S, H, D], or packed [total, H, D] with
    cu_seqlens. With cu_seqlens_q it is `flash_attn_unpadded` (K1v/K2v for
    self-attention without dropout); without, `scaled_dot_product_attention`
    with `bias` as its mask and q scaled by scale * sqrt(D) when `scale` is
    given."""
    if cu_seqlens_q is not None:
        out, _ = F.flash_attn_unpadded(
            query, key, value, cu_seqlens_q, cu_seqlens_k,
            max_seqlen_q, max_seqlen_k, scale=scale, dropout=dropout_p,
            causal=causal, training=training)
        return out
    q = query
    if scale is not None:
        q = query * (scale * math.sqrt(int(query.shape[-1])))
    return F.scaled_dot_product_attention(
        q, key, value, attn_mask=bias, dropout_p=dropout_p,
        is_causal=causal, training=training)
