"""LayerNorm and Dropout as torch `nn.Module`s, for the models.

Port of paddle_tpu/nn/layer/norm.py `LayerNorm` (:73-117) and
paddle_tpu/nn/layer/common.py `Dropout` as torch modules, which the GPT
and BERT models (torch `nn.Module`s until they move onto the port's
`nn.Layer`, ROADMAP.md item 11) hold. The public `nn.LayerNorm` and
`nn.Dropout` are the Layers of `nn.layer`. The class name `LayerNorm`
matters: `amp.decorate` at O2 keeps layers whose class name starts with
it in f32, as the reference's does.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as PF


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` axes with a weight
    (ones) and a bias (zeros), `nn.functional.layer_norm` (K3-LN when
    `FLAGS_pallas_fused_ops` is on)."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = epsilon
        factory = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              **factory))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             **factory))

    def forward(self, x, out_dtype=None):
        """`out_dtype=torch.float32` as the reference's O2 runs this op
        (BLACK_LIST: f32 in, f32 out)."""
        return PF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.eps, out_dtype)

    def forward_fused_add(self, x, residual):
        """(normed, summed) = (ln(x + residual), x + residual) by
        `nn.functional.fused_add_layer_norm` (one K3-LN launch when the
        flag is on). Under O2 the reference's autocast runs this op in the
        AMP dtype, weight and bias included: a bf16 or f16 stream here
        casts the f32 parameters to it (their gradients flow back through
        the cast)."""
        if len(self.normalized_shape) != 1:
            raise ValueError("fused add+LayerNorm normalizes the last axis "
                             "only")
        ct = torch.promote_types(x.dtype, residual.dtype)
        w, b = self.weight, self.bias
        if ct in (torch.bfloat16, torch.float16):
            w, b = w.to(ct), b.to(ct)
        return PF.fused_add_layer_norm(x, residual, w, b, self.eps)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, eps={self.eps}"


class Dropout(nn.Module):
    """`nn.functional.dropout` with probability `p` while training."""

    def __init__(self, p=0.5, mode="upscale_in_train"):
        super().__init__()
        self.p, self.mode = p, mode

    def forward(self, x):
        return PF.dropout(x, self.p, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
