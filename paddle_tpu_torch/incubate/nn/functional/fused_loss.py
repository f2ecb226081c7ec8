"""Fused linear + softmax cross-entropy over vocab OR token chunks.

Port of paddle_tpu/incubate/nn/functional/fused_loss.py
`fused_linear_cross_entropy`: mean cross-entropy of hidden @ weight over
the labels that are neither `ignore_index` nor negative, computed one
chunk at a time so that the [tokens, vocab] f32 logits never exist whole
in device memory. The forward keeps only the per-token logsumexp; the
backward recomputes each chunk's logits and forms (softmax - onehot)
chunk by chunk. The reference is an XLA composition (a `lax.scan` under a
custom VJP), not a Pallas kernel, so each path here is a
`torch.autograd.Function` of plain torch: cuBLAS GEMMs and pointwise ops,
one chunk at a time, with the reference's backward.

  vocab-chunked (`_FlceVocab`, the reference's `_flce`): an online
  logsumexp over vocab slices of a chunk that divides the vocab
  (`_best_chunk`: 32000 at 8192 -> 6400, 5 slices); h and each weight
  slice are upcast to f32, as the reference does. dW is written per
  vocab slice in the weight's dtype, dH summed in f32 and cast once.

  token-chunked (`_FlceTok`, the reference's `_flce_tok`): each token
  slice runs one [chunk, H] @ [H, V] GEMM in the operands' own dtype
  with f32 sums (`_mm_f32`; the [H, V] weight is not upcast in memory on
  a card) and reduces its rows in f32. It takes any vocab — ragged token
  counts pad with label -1 — so GPT's 50304, which has no usable vocab
  chunk, stays chunked. dH is written per slice in h's dtype, dW summed
  in f32.

  quantized head (`_FlceQuant`, the reference's `_flce_q`): an int8
  [K, V] or packed int4 [ceil(K/2), V] head with per-channel [V] scales,
  dequantized one vocab slice at a time; the head is frozen (dH only).

`fused_linear_cross_entropy_reference` is the unchunked plain version
(the whole f32 logits), the yardstick of the tests and `chip_smoke.py`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ....amp import amp_op
from ....core.flags import flag
from ....ops.quantized import dequant_int4, int4_unpack, packed_rows

__all__ = ["fused_linear_cross_entropy",
           "fused_linear_cross_entropy_reference"]

_HALF = (torch.bfloat16, torch.float16)


def _valid_mask(labels, ignore_index):
    # ignored tokens (ignore_index, or any negative label) contribute
    # nothing to the loss or the gradient, and the mean divides by the
    # non-ignored count
    return (labels != ignore_index) & (labels >= 0)


def _mean(per_token, valid):
    count = valid.sum().clamp_min(1).float()
    return torch.where(valid, per_token, 0.0).sum() / count


def _scale(g, valid):
    """The backward's per-token factor: g / count on valid rows, else 0."""
    return (g / valid.sum().clamp_min(1).float()) * valid.float()


def _mm_f32(a, b):
    """a @ b in the operands' common dtype with f32 sums, as an f32
    result (the reference's `_dot_f32`). bf16/f16 operands on a card take
    `aten::mm.dtype` (half-precision products, f32 accumulation, no
    upcast copy); elsewhere the operands are upcast, which gives the same
    f32 sums of the same exact products."""
    ct = torch.promote_types(a.dtype, b.dtype)
    if ct in _HALF and a.is_cuda:
        return torch.mm(a.to(ct), b.to(ct), out_dtype=torch.float32)
    wide = torch.promote_types(ct, torch.float32)
    return (a.to(wide) @ b.to(wide)).float()


def _lse_over_vocab(hf, labels, nchunks, chunk, cols):
    """Online logsumexp over vocab slices: (lse, the label's logit), both
    f32 [N]. `cols(i)` is the f32 [H, chunk] weight slice i."""
    n = hf.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=hf.device)
    s = torch.zeros(n, dtype=torch.float32, device=hf.device)
    lab_logit = torch.zeros(n, dtype=torch.float32, device=hf.device)
    for i in range(nchunks):
        logits = hf @ cols(i)                              # [N, chunk]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        local = labels - i * chunk
        inside = (local >= 0) & (local < chunk)
        picked = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        lab_logit = torch.where(inside, picked, lab_logit)
        m = m_new
    return m + torch.log(s), lab_logit


def _dlog_vocab(logits, lse, labels, i, chunk, scale):
    """(softmax - onehot) * scale of vocab slice i, in place of logits."""
    p = torch.exp(logits.sub_(lse[:, None]))
    local = labels - i * chunk
    inside = (local >= 0) & (local < chunk)
    p.scatter_add_(1, local.clamp(0, chunk - 1)[:, None],
                   -inside.float()[:, None])
    return p.mul_(scale[:, None])


class _FlceVocab(torch.autograd.Function):
    """The vocab-chunked path (the reference's `_flce`): h [N, H], w
    [H, V] with V % chunk == 0, labels [N] int64."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk, ignore_index):
        hf = h.float()
        lse, lab_logit = _lse_over_vocab(
            hf, labels, w.shape[1] // chunk, chunk,
            lambda i: w[:, i * chunk:(i + 1) * chunk].float())
        ctx.save_for_backward(h, w, labels, lse)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return _mean(lse - lab_logit, _valid_mask(labels, ignore_index))

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        hf = h.float()
        scale = _scale(g, _valid_mask(labels, ctx.ignore_index))
        dh = torch.zeros(hf.shape, dtype=torch.float32, device=h.device)
        # w's layout (a [V, H] weight's transpose: vocab slices are row
        # blocks of its storage)
        dw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
        for i in range(w.shape[1] // chunk):
            cols = slice(i * chunk, (i + 1) * chunk)
            wcf = w[:, cols].float()
            dlog = _dlog_vocab(hf @ wcf, lse, labels, i, chunk, scale)
            if dw is not None:
                dw[:, cols] = (dlog.T @ hf).T              # [H, chunk]
            dh += dlog @ wcf.T
        return dh.to(h.dtype), dw, None, None, None


class _FlceTok(torch.autograd.Function):
    """The token-chunked path (the reference's `_flce_tok`): h [N, H] with
    N % chunk_n == 0, w [H, V], labels [N] int64."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk_n, ignore_index):
        n, v = h.shape[0], w.shape[1]
        lse = torch.empty(n, dtype=torch.float32, device=h.device)
        lab_logit = torch.empty_like(lse)
        for i in range(n // chunk_n):
            rows = slice(i * chunk_n, (i + 1) * chunk_n)
            logits = _mm_f32(h[rows], w)                   # [cn, V] f32
            m = logits.amax(dim=-1)
            lse[rows] = m + torch.log(
                torch.exp(logits - m[:, None]).sum(dim=-1))
            lab_logit[rows] = logits.gather(
                1, labels[rows].clamp(0, v - 1)[:, None])[:, 0]
        ctx.save_for_backward(h, w, labels, lse)
        ctx.chunk_n, ctx.ignore_index = chunk_n, ignore_index
        # invalid rows picked a clipped label; the mask discards them
        return _mean(lse - lab_logit, _valid_mask(labels, ignore_index))

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        chunk_n = ctx.chunk_n
        n, v = h.shape[0], w.shape[1]
        scale = _scale(g, _valid_mask(labels, ctx.ignore_index))
        dh = torch.empty_like(h)
        # f32 sums in w's layout
        dw = (torch.zeros_like(w, dtype=torch.float32)
              if ctx.needs_input_grad[1] else None)
        for i in range(n // chunk_n):
            rows = slice(i * chunk_n, (i + 1) * chunk_n)
            hc = h[rows]
            p = torch.exp(_mm_f32(hc, w).sub_(lse[rows, None]))
            # rows with scale 0 (ignored or padded) zero the clipped
            # onehot too
            p.scatter_add_(1, labels[rows].clamp(0, v - 1)[:, None],
                           torch.full((chunk_n, 1), -1.0, device=h.device))
            dlog = p.mul_(scale[rows, None]).to(w.dtype)   # [cn, V]
            dh[rows] = _mm_f32(dlog, w.T)
            if dw is not None:
                # [V, H] product seen as [H, V]: w's layout when w is a
                # [V, H] weight's transpose, as the models pass it
                dw.add_(_mm_f32(dlog.T, hc).T)
        return (dh, None if dw is None else dw.to(w.dtype), None, None,
                None)


def _dequant_head_cols(wq, ws, k, j, chunk):
    """f32 vocab columns [j*chunk, (j+1)*chunk) of a weight-only-quantized
    head: wq the int8 [K, V] tensor or the int4 nibble-pack
    [ceil(K/2), V] (told apart by shape, as the reference's
    `quant_matmul` does), ws the per-channel scale [V]."""
    cols = slice(j * chunk, (j + 1) * chunk)
    wc = wq[:, cols]
    if wq.shape[0] != k and wq.shape[0] == packed_rows(k):
        wc = int4_unpack(wc, k, axis=0)
    return wc.float() * ws[cols].float()


class _FlceQuant(torch.autograd.Function):
    """The quantized-head path (the reference's `_flce_q`): h [N, K], the
    (wq, ws) pair, labels [N] int64. Returns dH only: the head is frozen
    (its scale gets zeros, the integer codes nothing)."""

    @staticmethod
    def forward(ctx, h, wq, ws, labels, chunk, ignore_index, k):
        hf = h.float()
        lse, lab_logit = _lse_over_vocab(
            hf, labels, ws.shape[0] // chunk, chunk,
            lambda i: _dequant_head_cols(wq, ws, k, i, chunk))
        ctx.save_for_backward(h, wq, ws, labels, lse)
        ctx.chunk, ctx.ignore_index, ctx.k = chunk, ignore_index, k
        return _mean(lse - lab_logit, _valid_mask(labels, ignore_index))

    @staticmethod
    def backward(ctx, g):
        h, wq, ws, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        hf = h.float()
        scale = _scale(g, _valid_mask(labels, ctx.ignore_index))
        dh = torch.zeros(hf.shape, dtype=torch.float32, device=h.device)
        for i in range(ws.shape[0] // chunk):
            wcf = _dequant_head_cols(wq, ws, ctx.k, i, chunk)
            dh += _dlog_vocab(hf @ wcf, lse, labels, i, chunk,
                              scale) @ wcf.T
        return (dh.to(h.dtype), None, torch.zeros_like(ws), None, None,
                None, None)


def _best_chunk(v, chunk_size):
    """The vocab chunk: the requested chunk_size when it divides v
    exactly; otherwise the largest multiple-of-128 divisor of v that keeps
    the scan at <= 64 chunks — vocab 32000 at 8192 -> 6400 (5 chunks).
    Returns 0 when there is none (e.g. 50304, whose only small
    multiple-of-128 divisor is 384): the caller then takes the token
    path."""
    cs = min(int(chunk_size), v)
    if cs <= 0:
        return 0
    if v % cs == 0:
        return cs
    best = 0
    for c in range(128, cs + 1, 128):
        if v % c == 0 and v // c <= 64:
            best = c
    return best


def fused_linear_cross_entropy_reference(hidden, weight, labels,
                                         ignore_index=-100):
    """The plain version: the same loss from the whole [N, V] f32 logits
    (h and w upcast to f32), differentiated by autograd."""
    h = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1)
    logits = h.float() @ weight.float()                    # [N, V] f32
    valid = _valid_mask(lab, ignore_index)
    loss = F.cross_entropy(logits, torch.where(valid, lab, 0),
                           reduction="none")
    return _mean(loss, valid)


def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=8192,
                               ignore_index=-100, name=None,
                               chunk_axis=None, token_chunk=None):
    """`_fused_linear_cross_entropy` as the reference's op
    "fused_linear_cross_entropy" under `amp.auto_cast`."""
    return amp_op("fused_linear_cross_entropy", _fused_linear_cross_entropy,
                  hidden, weight, labels, chunk_size, ignore_index, name,
                  chunk_axis, token_chunk)


def _fused_linear_cross_entropy(hidden, weight, labels, chunk_size=8192,
                                ignore_index=-100, name=None,
                                chunk_axis=None, token_chunk=None):
    """loss = mean CE(softmax(hidden @ weight), labels) without ever
    materialising the [tokens, vocab] logits, leaving ignore_index (and
    any negative) labels out of both the loss mean (at least 1) and the
    gradient. hidden [..., H] flattens to [N, H]; weight [H, V] (the
    port's models pass `lm_head.weight.T`); labels [...] int. weight may
    also be a weight-only-quantized (q, scale) pair (int8 [K, V] or
    packed int4 [ceil(K/2), V], per-channel scale [V]): the head is then
    dequantized one vocab slice at a time and is frozen (dH only); a vocab
    with no usable chunk dequantizes it once and takes the token path.
    Group-wise scales raise NotImplementedError.

    chunk_axis: "vocab" (online logsumexp over vocab slices), "tokens"
    (a full-vocab GEMM per token slice), or None / "auto" —
    FLAGS_flce_chunk_axis decides, and "auto" takes the vocab path when a
    multiple-of-128 divisor exists (`_best_chunk`) and the token path
    otherwise. token_chunk defaults to FLAGS_flce_token_chunk; <= 0 turns
    the token path off. chunk_size <= 0 (or no divisor) on the vocab axis
    gives the unchunked logits path (`fused_linear_cross_entropy_reference`,
    the reference's sweep baseline). `name` is accepted, as the
    reference's."""
    h = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1).long()
    if isinstance(weight, (tuple, list)):
        wq, ws = weight
        if ws.dim() != 1:
            raise NotImplementedError(
                "fused_linear_cross_entropy: group-wise scales are not "
                "supported for the quantized head (per-channel [V] only)")
        k = int(h.shape[-1])
        chunk = _best_chunk(int(ws.shape[-1]), chunk_size)
        if chunk:
            return _FlceQuant.apply(h, wq, ws, lab, chunk, int(ignore_index),
                                    k)
        # no usable vocab chunk (GPT's 50304): the head dequantized once
        # (transient), then the token path
        if wq.shape[0] != k and wq.shape[0] == packed_rows(k):
            weight = dequant_int4(wq, ws, k)
        else:
            weight = wq.float() * ws.float()
    v = int(weight.shape[-1])
    axis = chunk_axis or str(flag("FLAGS_flce_chunk_axis"))
    if token_chunk is None:
        token_chunk = int(flag("FLAGS_flce_token_chunk"))
    chunk = _best_chunk(v, chunk_size)
    if axis == "auto":
        axis = "vocab" if chunk else "tokens"
    if axis == "tokens" and token_chunk > 0:
        # the requested size exactly (capped at 2^20 tokens)
        c = min(int(token_chunk), 1 << 20, h.shape[0])
        pad = (-h.shape[0]) % c
        if pad:
            # padded rows carry a negative label: out of the mean, zero in
            # the gradient; the pad's backward cuts their dh rows off
            h = F.pad(h, (0, 0, 0, pad))
            lab = F.pad(lab, (0, pad), value=-1)
        return _FlceTok.apply(h, weight, lab, c, int(ignore_index))
    if not chunk:
        return fused_linear_cross_entropy_reference(h, weight, lab,
                                                    ignore_index)
    return _FlceVocab.apply(h, weight, lab, chunk, int(ignore_index))
