"""ViterbiDecoder: CRF max-sum decoding.

Port of paddle_tpu/text/viterbi.py. The reference's decoder is one
`lax.scan` over time (an XLA loop, no Pallas kernel), so the port's is
an op of the Tensor API in plain torch: a Python loop over the time
steps, each a batched max over [B, N, N] scores. Ties pick the lowest
tag, as jnp's argmax; the scores' gradient (through `amax`) splits among
tied paths evenly, as jnp's max does.
"""
from __future__ import annotations

import torch

from ..core.dispatch import op
from ..nn.layer_base import Layer

__all__ = ['ViterbiDecoder', 'viterbi_decode']


@op("viterbi_decode")
def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """potentials [B, T, N], transitions [N, N] (the start tag's row
    N - 1 and the stop tag's row N - 2 when include_bos_eos_tag), lengths
    [B] -> (scores [B], paths [B, T] int64). Positions past a sequence's
    length repeat its last tag (only the first `lengths` are
    meaningful)."""
    emit, trans, lens = potentials, transition_params, lengths
    b, t, n = emit.shape
    if include_bos_eos_tag:
        start, stop = trans[n - 1][None, :], trans[n - 2][None, :]
    else:
        start = stop = emit.new_zeros(1, n)
    alpha = emit[:, 0] + start                          # [B, N]
    keep = torch.arange(n, device=emit.device).expand(b, n)
    backptrs = []
    for i in range(1, t):
        scores = alpha[:, :, None] + trans[None, :, :]  # [B, N(prev), N]
        valid = (i < lens)[:, None]
        alpha = torch.where(valid, scores.amax(1) + emit[:, i], alpha)
        backptrs.append(torch.where(valid, scores.argmax(1), keep))
    final = alpha + stop
    tag = final.argmax(-1)                              # [B]
    tags = [tag]
    for bp in reversed(backptrs):
        tag = bp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    return final.amax(-1), torch.stack(tags[::-1], 1).long()


class ViterbiDecoder(Layer):
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
