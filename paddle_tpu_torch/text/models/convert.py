"""Carry LLaMA, GPT and BERT weights into the port from numpy arrays.

The port's models have the reference's `state_dict` (keys, [in, out]
Linear weights, dtypes), so a paddle_tpu state dict as numpy loads by
`set_state_dict` as it is: `llama_from_numpy`, `gpt_from_numpy` and
`bert_from_numpy` build the model and copy the arrays in, and the
`*_to_numpy` functions give its `state_dict` back as numpy. LLaMA's keys
carry the prefix "llama." (the reference's) or "model." (its alias).
paddle_tpu's serving params (its stacked, possibly weight-only-quantized
dict) load as the port's per-layer serving params.
"""
from __future__ import annotations

import numpy as np
import torch

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
    another) in `dtype`, holding the weights of `state` {name: ndarray}
    (keys under "llama." or "model."). Raises on missing or unexpected
    keys and on shape mismatches."""
    return _load_numpy(
        LlamaForCausalLM(cfg, device=device, dtype=dtype),
        {"llama." + k[len("model."):] if k.startswith("model.") else k: a
         for k, a in state.items()})


def llama_to_numpy(model: LlamaForCausalLM, prefix="llama.") -> dict:
    """The inverse of `llama_from_numpy`: {name: f32 ndarray}, the
    model's state dict with its keys under `prefix`, whatever the model's
    dtype: copies, which later updates of the model leave alone."""
    return {prefix + k[len("llama."):] if k.startswith("llama.") else k: a
            for k, a in _to_numpy(model).items()}


def _load_numpy(model, state: dict):
    """`model.set_state_dict(state)` from {key: ndarray}. Raises
    RuntimeError on missing or unexpected keys and on shape mismatches
    (as torch's `load_state_dict`)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise RuntimeError(f"state dict mismatch: missing {missing}, "
                           f"unexpected {unexpected}")
    sd = {k: _tensor(a, "cpu") for k, a in state.items()}
    for k, t in sd.items():
        if list(t.shape) != own[k].shape:
            raise RuntimeError(f"{k}: shape {list(t.shape)} in the state "
                               f"dict, {own[k].shape} in the model")
    model.set_state_dict(sd)
    return model


def _to_numpy(model) -> dict:
    """{key: f32 ndarray} of the model's state dict, whatever its dtype:
    copies, which later updates of the model leave alone."""
    return {key: np.array(t._data.detach().float().cpu().numpy())
            for key, t in model.state_dict().items()}


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


def state_dict_shapes(cfg, num_classes=2) -> list:
    """[(key, shape)] of the state dict of the model `cfg` configures
    (LlamaForCausalLM, GPTForCausalLM, or BertForSequenceClassification
    with `num_classes`), in order, by the reference's naming: a checkpoint
    of either package holds these keys and shapes."""
    h = cfg.hidden_size
    if isinstance(cfg, LlamaConfig):
        hd, kv = cfg.head_dim, cfg.num_key_value_heads
        i = cfg.intermediate_size
        out = [("llama.embed_tokens.weight", [cfg.vocab_size, h])]
        for n in range(cfg.num_hidden_layers):
            p = f"llama.layers.{n}."
            out += [(p + "self_attn.q_proj.weight",
                     [h, cfg.num_attention_heads * hd]),
                    (p + "self_attn.k_proj.weight", [h, kv * hd]),
                    (p + "self_attn.v_proj.weight", [h, kv * hd]),
                    (p + "self_attn.o_proj.weight",
                     [cfg.num_attention_heads * hd, h]),
                    (p + "mlp.gate_proj.weight", [h, i]),
                    (p + "mlp.up_proj.weight", [h, i]),
                    (p + "mlp.down_proj.weight", [i, h]),
                    (p + "input_layernorm.weight", [h]),
                    (p + "post_attention_layernorm.weight", [h])]
        out.append(("llama.norm.weight", [h]))
        if not cfg.tie_word_embeddings:
            out.append(("lm_head.weight", [h, cfg.vocab_size]))
        return out
    i = cfg.intermediate_size
    if isinstance(cfg, GPTConfig):
        out = [("wte.weight", [cfg.vocab_size, h]),
               ("wpe.weight", [cfg.max_position_embeddings, h])]
        for n in range(cfg.num_hidden_layers):
            p = f"blocks.{n}."
            out += [(p + "ln_1.weight", [h]), (p + "ln_1.bias", [h]),
                    (p + "attn.qkv_proj.weight", [h, 3 * h]),
                    (p + "attn.out_proj.weight", [h, h]),
                    (p + "ln_2.weight", [h]), (p + "ln_2.bias", [h]),
                    (p + "fc_in.weight", [h, i]),
                    (p + "fc_out.weight", [i, h])]
        return out + [("ln_f.weight", [h]), ("ln_f.bias", [h]),
                      ("lm_head.weight", [h, cfg.vocab_size])]
    e = "bert.embeddings."
    out = [(e + "word_embeddings.weight", [cfg.vocab_size, h]),
           (e + "position_embeddings.weight",
            [cfg.max_position_embeddings, h]),
           (e + "token_type_embeddings.weight", [cfg.type_vocab_size, h]),
           (e + "layer_norm.weight", [h]), (e + "layer_norm.bias", [h])]
    for n in range(cfg.num_hidden_layers):
        p = f"bert.encoder.{n}."
        for lin in ("query", "key", "value", "out"):
            out += [(f"{p}attention.{lin}.weight", [h, h]),
                    (f"{p}attention.{lin}.bias", [h])]
        out += [(p + "attn_norm.weight", [h]), (p + "attn_norm.bias", [h]),
                (p + "intermediate.weight", [h, i]),
                (p + "intermediate.bias", [i]),
                (p + "output.weight", [i, h]), (p + "output.bias", [h]),
                (p + "out_norm.weight", [h]), (p + "out_norm.bias", [h])]
    return out + [("bert.pooler.weight", [h, h]), ("bert.pooler.bias", [h]),
                  ("classifier.weight", [h, num_classes]),
                  ("classifier.bias", [num_classes])]
