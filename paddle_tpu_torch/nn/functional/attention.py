"""Scaled dot-product attention.

Port of paddle_tpu/nn/functional/attention.py: `scaled_dot_product_attention`
over [B, S, H, D] tensors. Where the reference sends an unmasked,
dropout-free call to its Pallas flash kernel, the port runs the flash op
(K1 forward, K2 backward on CUDA tensors, their plain versions on CPU
ones); the rest is the reference's composition `_xla_sdpa` in torch.
"""
from __future__ import annotations

import math

import torch

from ...amp import amp_op
from ...ops.flash_attention import flash_attention


def _keep_mask(x, p, generator):
    """A 0/1 tensor in x's dtype and shape, each element 1 with
    probability 1 - p, drawn with `generator` (torch's default generator
    of x's device when None)."""
    return torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)


def _scaled_dot_product_attention(query, key, value, attn_mask=None,
                                  dropout_p=0.0, is_causal=False,
                                  training=True, generator=None):
    """softmax(q k^T / sqrt(D) (+ mask)) v over [B, S, H, D] tensors; k/v
    may carry fewer heads than q (GQA). No mask and no dropout (p == 0 or
    not training): the differentiable flash op (K1 forward, K2 backward
    on CUDA). Otherwise the reference's plain composition `_xla_sdpa`:
    kv heads repeated, f32 softmax, probabilities in q's dtype, the mask
    (bool: True keeps; else added to the scores), then dropout on the
    probabilities with a keep mask drawn from `generator` (torch's
    default generator of q's device when None) and 1 / (1 - p) scaling."""
    p = dropout_p if training else 0.0
    if attn_mask is None and p == 0.0:
        out, _ = flash_attention(query.transpose(1, 2).contiguous(),
                                 key.transpose(1, 2).contiguous(),
                                 value.transpose(1, 2).contiguous(),
                                 causal=is_causal)
        return out.transpose(1, 2)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    low = torch.finfo(scores.dtype).min
    if is_causal:
        sq, sk = scores.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~keep, low)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, low)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if p > 0.0:
        keep = _keep_mask(probs, p, generator).bool()
        probs = torch.where(keep, probs / (1.0 - p), 0.0).to(probs.dtype)
    return (probs @ v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """`_scaled_dot_product_attention` as the reference's op
    "scaled_dot_product_attention" (its inputs cast by the AMP rule when
    `auto_cast` is on)."""
    return amp_op("scaled_dot_product_attention",
                  _scaled_dot_product_attention, query, key, value,
                  attn_mask, dropout_p, is_causal, training, generator)
