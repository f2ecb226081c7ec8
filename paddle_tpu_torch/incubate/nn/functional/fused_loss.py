"""Linear + softmax cross-entropy: the LLaMA training loss.

Port of paddle_tpu/incubate/nn/functional/fused_loss.py
`fused_linear_cross_entropy`: the same function (mean cross-entropy of
hidden @ weight over the labels that are neither `ignore_index` nor
negative, the logits in f32 from the model-dtype operands, the gradient
back in the operands' dtypes). The reference is an XLA composition, not a
Pallas kernel, so this is plain torch. It materialises the [tokens, vocab]
f32 logits: the reference's vocab/token chunking, which keeps them out of
device memory, is a memory lever that comes with the next training
slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100):
    """hidden [..., H] (flattened to [N, H]), weight [H, V], labels [...]
    int -> scalar f32 loss. Ignored labels count in neither the loss nor
    the mean's denominator (at least 1)."""
    h = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1)
    logits = h.float() @ weight.float()                    # [N, V] f32
    valid = (lab != ignore_index) & (lab >= 0)
    loss = F.cross_entropy(logits, torch.where(valid, lab, 0),
                           reduction="none")
    count = valid.sum().clamp_min(1).float()
    return torch.where(valid, loss, 0.0).sum() / count
