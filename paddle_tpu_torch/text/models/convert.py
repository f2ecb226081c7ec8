"""Carry LLaMA, GPT and BERT weights into the port from numpy arrays.

The state dict of a paddle_tpu `LlamaForCausalLM` (as numpy) loads
directly: its keys carry the prefix "llama." (or "model."), and its
Linear weights are [in, out], which are transposed here to torch's
[out, in]; `llama_to_numpy` is the way back. paddle_tpu's serving params
(its stacked, possibly weight-only-quantized dict) load as the port's
per-layer serving params. A paddle_tpu `GPTForCausalLM` or
`BertForSequenceClassification` state dict loads under the same keys as
the port's modules (`gpt_from_numpy`, `bert_from_numpy`), every Linear
weight transposed; `gpt_to_numpy` / `bert_to_numpy` are the way back.
"""
from __future__ import annotations

import numpy as np
import torch

from torch import nn

from ...ops._cuda_common import resolve_device
from .bert import BertConfig, BertForSequenceClassification
from .gpt import GPTConfig, GPTForCausalLM
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
    prefix = "model." if any(k.startswith("model.") for k in state) \
        else "llama."
    return _load_numpy(
        LlamaForCausalLM(cfg, device=device, dtype=dtype),
        {"model." + k[len(prefix):] if k.startswith(prefix) else k: a
         for k, a in state.items()})


def llama_to_numpy(model: LlamaForCausalLM, prefix="llama.") -> dict:
    """The inverse of `llama_from_numpy`: {name: f32 ndarray} in the
    reference's state-dict layout (keys under `prefix`, Linear weights
    [in, out]), whatever the model's dtype: copies, which later updates
    of the model leave alone."""
    return {prefix + k[len("model."):] if k.startswith("model.") else k: a
            for k, a in _to_numpy(model).items()}


def _linear_keys(model) -> set:
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Linear)}


def _load_numpy(model, state: dict):
    """Load {key: ndarray} into `model` under the same keys, Linear
    weights [in, out] -> [out, in]. Raises on missing or unexpected keys
    and on shape mismatches."""
    linear = _linear_keys(model)
    sd = {k: _tensor(a, "cpu").T if k in linear else _tensor(a, "cpu")
          for k, a in state.items()}
    model.load_state_dict(sd, strict=True)
    return model


def _to_numpy(model) -> dict:
    """{key: f32 ndarray} in the reference's layout (Linear weights
    [in, out]), whatever the model's dtype: copies, which later updates
    of the model leave alone."""
    linear = _linear_keys(model)
    out = {}
    for key, t in model.state_dict().items():
        a = t.detach().float().cpu()
        out[key] = np.array((a.T if key in linear else a).numpy())
    return out


def gpt_from_numpy(cfg: GPTConfig, state: dict, device=None,
                   dtype=torch.float32) -> GPTForCausalLM:
    """A GPTForCausalLM on `device` ("cuda" unless the caller asks for
    another) in `dtype`, holding the weights of paddle_tpu's GPT state
    dict {name: ndarray}."""
    return _load_numpy(GPTForCausalLM(cfg, device=device, dtype=dtype), state)


def gpt_to_numpy(model: GPTForCausalLM) -> dict:
    """The inverse of `gpt_from_numpy`."""
    return _to_numpy(model)


def bert_from_numpy(cfg: BertConfig, state: dict, num_classes=2,
                    device=None,
                    dtype=torch.float32) -> BertForSequenceClassification:
    """A BertForSequenceClassification on `device` ("cuda" unless the
    caller asks for another) in `dtype`, holding the weights of
    paddle_tpu's state dict {name: ndarray} (keys "bert.*" and
    "classifier.*")."""
    return _load_numpy(BertForSequenceClassification(
        cfg, num_classes, device=device, dtype=dtype), state)


def bert_to_numpy(model: BertForSequenceClassification) -> dict:
    """The inverse of `bert_from_numpy`."""
    return _to_numpy(model)
