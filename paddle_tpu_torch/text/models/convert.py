"""Carry LLaMA weights into the port from numpy arrays.

The state dict of a paddle_tpu `LlamaForCausalLM` (as numpy) loads
directly: its keys carry the prefix "llama." (or "model."), and its
Linear weights are [in, out], which are transposed here to torch's
[out, in]; `llama_to_numpy` is the way back. paddle_tpu's serving params
(its stacked, possibly weight-only-quantized dict) load as the port's
per-layer serving params.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops._cuda_common import resolve_device
from .llama import LlamaConfig, LlamaForCausalLM


def _tensor(arr, device) -> torch.Tensor:
    """A private copy of `arr` on `device`; numpy bfloat16 (ml_dtypes)
    travels bit for bit."""
    a = np.array(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def serving_params_from_numpy(params: dict, device=None) -> dict:
    """paddle_tpu's LLaMA serving params (`text.generation._stacked_params`
    output, arrays as numpy: dense [L, ...] arrays and, under weight-only
    quantization, (q, scale) pairs) -> the port's serving params on
    `device` ("cuda" unless the caller asks for another): the same
    tensors, with the stacked layers split into a per-layer list of dicts,
    as `text.generation._extract_llama` returns them."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, tuple):
            return tuple(_tensor(a, dev) for a in v)
        return _tensor(v, dev)

    def layer(v, i):
        return tuple(a[i] for a in v) if isinstance(v, tuple) else v[i]

    stacked = {k: conv(v) for k, v in params["layers"].items()}
    first = next(iter(stacked.values()))
    n_layers = (first[0] if isinstance(first, tuple) else first).shape[0]
    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: layer(v, i) for k, v in stacked.items()}
                     for i in range(n_layers)]
    return out


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
        if _is_linear(key):
            t = t.T                       # [in, out] -> [out, in]
        sd[key] = t
    model.load_state_dict(sd, strict=True)
    return model


def _is_linear(key: str) -> bool:
    return key.endswith("_proj.weight") or key == "lm_head.weight"


def llama_to_numpy(model: LlamaForCausalLM, prefix="llama.") -> dict:
    """The inverse of `llama_from_numpy`: {name: f32 ndarray} in the
    reference's state-dict layout (keys under `prefix`, Linear weights
    [in, out]), whatever the model's dtype."""
    out = {}
    for key, t in model.state_dict().items():
        a = t.detach().float().cpu()
        if _is_linear(key):
            a = a.T                       # [out, in] -> [in, out]
        if key.startswith("model."):
            key = prefix + key[len("model."):]
        out[key] = np.ascontiguousarray(a.numpy())
    return out
