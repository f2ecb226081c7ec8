"""The varlen and FlashMask attention APIs.

Port of paddle_tpu/nn/functional/extended.py `_host_cu` (:908),
`flash_attn_unpadded` (:914), `flash_attn_varlen_qkvpacked` (:1001) and
`flashmask_attention` (:1020), with the reference's signatures, errors and
routing:

  * varlen: the packed [total, H, D] tokens are gathered into a padded
    [B, S_bucket, H, D] batch (S_bucket = `default_buckets(max_seqlen)`),
    attention runs batched, and the output is gathered back. Self-attention
    (cu_q == cu_k, equal buckets) with no dropout runs the varlen flash op
    (K1v forward, K2v backward on CUDA: key columns past a sequence's
    length masked inside the kernel); the rest runs the reference's
    composition (a per-sequence validity mask, bottom-right causal by
    actual lengths) through the masked `scaled_dot_product_attention`.
  * FlashMask: the single-column causal form ([B, Hm, S, 1] start rows)
    with no dropout, S == Sk and Hq == Hkv runs the block-sparse op (K9
    forward and backward on CUDA); the start+end forms (2 or 4 columns),
    dropout and GQA build the reference's dense additive mask and run the
    masked `scaled_dot_product_attention`.

The reference takes its kernels only on a TPU, and FlashMask's only at
S >= 4096; the port takes them at any size on every device, as it does for
the fused ops: the kernels compute the same function at any S. On the CPU
the same route runs the kernels' plain versions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...jit.api import default_buckets
from ...ops.flash_attention import flash_attention_varlen_raw
from ...ops.flashmask import flashmask_attention_raw


def _host_cu(x):
    """cu_seqlens as host ints (a tensor, array or list; int64)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen ("unpadded") attention: query/key/value packed [total, H, D]
    with cu_seqlens boundaries [B + 1]. Returns (out [total_q, H, D],
    None). `scale` multiplies the scores in place of 1/sqrt(D). Routes as
    the module docstring says: K1v/K2v for self-attention with no dropout,
    the masked composition otherwise."""
    from . import scaled_dot_product_attention

    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True): ragged per-segment "
            "weights; run flash_attn_qkvpacked on a padded batch to inspect "
            "attention weights")
    cu_q = _host_cu(cu_seqlens_q)
    cu_k = _host_cu(cu_seqlens_k)
    total_q = int(cu_q[-1])
    sq = default_buckets(int(max_seqlen_q))
    sk = default_buckets(int(max_seqlen_k))
    # gather indices [B, S]: row b position i <- packed index cu[b] + i
    iq = np.minimum(cu_q[:-1, None] + np.arange(sq)[None, :], total_q - 1)
    ik = np.minimum(cu_k[:-1, None] + np.arange(sk)[None, :],
                    int(cu_k[-1]) - 1)
    lens_k = (cu_k[1:] - cu_k[:-1]).astype(np.int32)
    lens_q = (cu_q[1:] - cu_q[:-1]).astype(np.int32)
    # gather-back map: packed token t lives at (seq_id[t], pos[t])
    tpos = np.arange(total_q)
    seq_id = np.searchsorted(cu_q, tpos, side="right") - 1
    pos = tpos - cu_q[seq_id]
    drop = dropout if training else 0.0
    use_flash = drop == 0.0 and np.array_equal(cu_q, cu_k) and sq == sk

    dev = query.device

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    qp = query[on_dev(iq)]                  # [B, Sq, H, D]
    kp = key[on_dev(ik)]
    vp = value[on_dev(ik)]
    if scale is not None:
        d = query.shape[-1]
        qp = qp * torch.tensor(float(scale) * math.sqrt(d), dtype=qp.dtype,
                               device=dev)
    lk = on_dev(lens_k)
    if use_flash:
        out = flash_attention_varlen_raw(
            qp.transpose(1, 2).contiguous(), kp.transpose(1, 2).contiguous(),
            vp.transpose(1, 2).contiguous(), lk, causal=causal)
        out = out.transpose(1, 2)
    else:
        mask = (torch.arange(sk, device=dev)[None, :]
                < lk[:, None])[:, None, None, :]     # [B, 1, 1, Sk]
        if causal:
            # bottom-right aligned per sequence by actual lengths: query
            # row i of sequence b sees key columns j <= i + len_k - len_q
            rows = torch.arange(sq, device=dev)[None, :, None]
            cols = torch.arange(sk, device=dev)[None, None, :]
            off = (lk - on_dev(lens_q))[:, None, None]
            mask = mask & (cols <= rows + off)[:, None]
        out = scaled_dot_product_attention(qp, kp, vp, mask, drop, False)
    return out[on_dev(seq_id), on_dev(pos)], None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                training=True, name=None):
    """Varlen attention on packed [total, 3, H, D] q/k/v, routed through
    `flash_attn_unpadded`. Returns (out [total, H, D], None)."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_varlen_qkvpacked(return_softmax=True): per-segment "
            "softmax weights are ragged; use flash_attn_qkvpacked on padded "
            "batches to inspect attention weights")
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale, dropout,
                               causal, return_softmax, training=training,
                               name=name)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, name=None):
    """FlashMask sparse attention over [B, S, H, D] tensors.
    startend_row_indices [B, Hm, S, {1, 2, 4}] (Hm 1 or H): causal takes
    [LTS] (key column j hidden from query rows i >= start[j]) and
    [LTS, LTE]; non-causal [LTS, UTE] and [LTS, LTE, UTS, UTE]. The
    single-column causal form with no dropout, S == Sk and Hq == Hkv runs
    the block-sparse op (K9); the rest the dense additive mask through the
    masked `scaled_dot_product_attention`. A row that every column hides
    is 0 on the K9 route and NaN on the dense one, as in the reference."""
    from . import scaled_dot_product_attention

    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None, dropout,
                                            causal)
    s = query.shape[1]
    sk = key.shape[1]
    nc = int(startend_row_indices.shape[-1])
    allowed = (1, 2) if causal else (2, 4)
    if nc not in allowed:
        raise ValueError(
            f"flashmask_attention: startend_row_indices last dim must be "
            f"{allowed} for causal={causal}, got {nc} "
            f"(≙ flashmask_attention shape contract, "
            f"nn/functional/flash_attention.py)")
    hq = query.shape[2]
    if dropout == 0.0 and s == sk and nc == 1 and key.shape[2] == hq:
        sr = startend_row_indices[..., 0]          # [B, Hm, S]
        if sr.shape[1] != hq:
            sr = sr.expand(sr.shape[0], hq, sr.shape[2])
        out = flashmask_attention_raw(
            query.transpose(1, 2).contiguous(),
            key.transpose(1, 2).contiguous(),
            value.transpose(1, 2).contiguous(),
            sr.to(torch.int32).contiguous(), causal=causal)
        return out.transpose(1, 2)

    idx = startend_row_indices
    rows = torch.arange(s, device=idx.device)[None, None, :, None]

    def col(j):                                    # [B, Hm, 1, S]
        return idx[..., j:j + 1].transpose(2, 3)

    # a key column j is BLOCKED for query rows inside the named bands
    if causal:
        if nc == 1:
            blocked = rows >= col(0)
        else:
            blocked = (rows >= col(0)) & (rows < col(1))
    else:
        if nc == 2:
            blocked = (rows >= col(0)) | (rows < col(1))
        else:
            blocked = ((rows >= col(0)) & (rows < col(1))) \
                | ((rows >= col(2)) & (rows < col(3)))
    amask = torch.zeros(blocked.shape, dtype=query.dtype,
                        device=query.device).masked_fill(blocked,
                                                         float("-inf"))
    return scaled_dot_product_attention(query, key, value, amask, dropout,
                                        causal)
