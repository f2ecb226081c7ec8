"""Linear + softmax cross-entropy: the LLaMA training loss.

Port of paddle_tpu/incubate/nn/functional/fused_loss.py
`fused_linear_cross_entropy`: the same function (mean cross-entropy of
hidden @ weight over the labels that are neither `ignore_index` nor
negative, the logits in f32 from the model-dtype operands, the gradient
back in the operands' dtypes). The reference is an XLA composition, not a
Pallas kernel, so this is plain torch. It takes the reference's chunking
arguments (`chunk_size`, `chunk_axis`, `token_chunk`) and computes the
same loss unchunked: it materialises the [tokens, vocab] f32 logits,
where the reference's vocab/token chunking keeps them out of device
memory (a memory lever that comes with ROADMAP Queue 1 item 1b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=8192,
                               ignore_index=-100, chunk_axis=None,
                               token_chunk=None):
    """hidden [..., H] (flattened to [N, H]), weight [H, V], labels [...]
    int -> scalar f32 loss. Ignored labels count in neither the loss nor
    the mean's denominator (at least 1). `chunk_size`, `chunk_axis` and
    `token_chunk` are accepted as the reference's and do not change the
    result (no chunking yet)."""
    h = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1)
    logits = h.float() @ weight.float()                    # [N, V] f32
    valid = (lab != ignore_index) & (lab >= 0)
    loss = F.cross_entropy(logits, torch.where(valid, lab, 0),
                           reduction="none")
    count = valid.sum().clamp_min(1).float()
    return torch.where(valid, loss, 0.0).sum() / count
