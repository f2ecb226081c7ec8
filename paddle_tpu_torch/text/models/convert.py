"""Carry LLaMA weights into the port from numpy arrays.

The state dict of a paddle_tpu `LlamaForCausalLM` (as numpy) loads
directly: its keys carry the prefix "llama." (or "model."), and its
Linear weights are [in, out], which are transposed here to torch's
[out, in].
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig, LlamaForCausalLM


def llama_from_numpy(cfg: LlamaConfig, state: dict, device=None,
                     dtype=torch.float32) -> LlamaForCausalLM:
    """A LlamaForCausalLM on `device` ("cuda" unless the caller asks for
    another) in `dtype`, holding the weights of `state` {name: ndarray}.
    Raises on missing or unexpected keys and on shape mismatches."""
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    prefix = "model." if any(k.startswith("model.") for k in state) \
        else "llama."
    sd = {}
    for name, arr in state.items():
        key = "model." + name[len(prefix):] if name.startswith(prefix) \
            else name
        t = torch.from_numpy(np.array(arr))   # a private, writable copy
        if key.endswith("_proj.weight") or key == "lm_head.weight":
            t = t.T                       # [in, out] -> [out, in]
        sd[key] = t
    model.load_state_dict(sd, strict=True)
    return model
