"""The LLaMA block math shared by the model and the serving engine.

Port of the helpers paddle_tpu/inference/engine.py imports from
paddle_tpu/text/generation.py: `_GenSpec`, `_rms_norm`, `_rope`,
`_rope_tables_np`, `_mm`, `_layer_forward_prefill`, `_logits` and the
weight extraction (`_repeat_kv` has no use here: the attention functions
index or repeat GQA kv heads themselves). Same arithmetic and dtype rules
as the reference; what differs is the mechanism: eager torch and a Python
loop over layers, where the reference traced one program and scanned
stacked weights. Weights are not stacked: the extracted parameter dict
holds views of the model's own tensors, so serving costs no copy of the
weights.

Weight layout: the model keeps torch's `nn.Linear` layout [out, in]; the
extracted layer dicts hold the transposed views [in, out], so `_mm` is the
reference's plain `x @ w`.

The static single-program `generate` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.flags import flag
from ..ops.flash_attention import flash_attention_fwd


@dataclass(frozen=True)
class _GenSpec:
    """Static configuration of the LLaMA block math."""
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float
    rms_eps: float
    tie_embeddings: bool


def _spec_from_config(cfg) -> _GenSpec:
    return _GenSpec(num_layers=cfg.num_hidden_layers,
                    num_heads=cfg.num_attention_heads,
                    num_kv_heads=cfg.num_key_value_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    rms_eps=cfg.rms_norm_eps,
                    tie_embeddings=bool(cfg.tie_word_embeddings))


def _rms_norm(x, w, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope(x, cos, sin):
    # x [..., D]; cos/sin broadcastable [..., D]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos + rotated * sin


def _rope_tables_np(max_len, head_dim, theta, dtype):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    emb = np.concatenate([freqs, freqs], axis=-1)  # [T, D]
    return np.cos(emb).astype(dtype), np.sin(emb).astype(dtype)


def _rope_tables(cfg, dtype, device):
    """cos/sin [max_position_embeddings, head_dim] in the model's dtype,
    computed in f32 (f64 -> f32 -> dtype, as the reference)."""
    cos, sin = _rope_tables_np(cfg.max_position_embeddings, cfg.head_dim,
                               cfg.rope_theta, "float32")
    return (torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype))


def _mm(x, w):
    """x @ w with w [in, out] (dense weights only: weight-only quantization
    is not ported yet)."""
    return x @ w


def _layer_forward_prefill(x, lw, spec: _GenSpec, cos, sin,
                           attention=flash_attention_fwd):
    """One decoder block over the full prompt. x [B, S, H]; cos/sin
    [>=S, D]. Attention goes through `attention` ([B, H, S, D] layout,
    returns (o, lse)): the flash kernel by default, which takes its plain
    version for CPU tensors. Returns (x, (k, v)) with k/v [B, S, Hkv, D]."""
    b, s, h = x.shape
    hn = _rms_norm(x, lw["input_ln"], spec.rms_eps)
    flat = hn.reshape(b * s, h)
    q = _mm(flat, lw["q"]).reshape(b, s, spec.num_heads, spec.head_dim)
    k = _mm(flat, lw["k"]).reshape(b, s, spec.num_kv_heads, spec.head_dim)
    v = _mm(flat, lw["v"]).reshape(b, s, spec.num_kv_heads, spec.head_dim)
    c = cos[None, :s, None, :]
    sn = sin[None, :s, None, :]
    q = _rope(q, c, sn)
    k = _rope(k, c, sn)
    out, _ = attention(q.transpose(1, 2).contiguous(),
                       k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(), causal=True)
    out = out.transpose(1, 2)
    attn = _mm(out.reshape(b * s, spec.num_heads * spec.head_dim), lw["o"])
    x = x + attn.reshape(b, s, h)
    hn = _rms_norm(x, lw["post_ln"], spec.rms_eps).reshape(b * s, h)
    mlp = _mm(F.silu(_mm(hn, lw["gate"])) * _mm(hn, lw["up"]), lw["down"])
    return x + mlp.reshape(b, s, h), (k, v)


def _logits(x, params, spec: _GenSpec):
    """x [B, H] -> f32 logits [B, V]."""
    x = _rms_norm(x, params["final_ln"], spec.rms_eps)
    if spec.tie_embeddings:
        return x.float() @ params["embed"].float().T
    return x.float() @ params["lm_head"].float()


def _layer_weights(layer) -> dict:
    """One LlamaDecoderLayer's weights as the block math reads them
    (views, [in, out] for the matmuls)."""
    at, mlp = layer.self_attn, layer.mlp
    return {"q": at.q_proj.weight.T, "k": at.k_proj.weight.T,
            "v": at.v_proj.weight.T, "o": at.o_proj.weight.T,
            "gate": mlp.gate_proj.weight.T, "up": mlp.up_proj.weight.T,
            "down": mlp.down_proj.weight.T,
            "input_ln": layer.input_layernorm.weight,
            "post_ln": layer.post_attention_layernorm.weight}


@torch.no_grad()
def _extract_llama(model) -> dict:
    """The serving parameter dict of a LlamaForCausalLM: views of its
    weights (no copy), a per-layer list in place of the reference's
    stacked [L, ...] arrays, and the rope tables in the model's dtype."""
    m = model.model
    params = {"embed": m.embed_tokens.weight, "final_ln": m.norm.weight,
              "layers": [_layer_weights(layer) for layer in m.layers]}
    if model.lm_head is not None:
        params["lm_head"] = model.lm_head.weight.T
    params["rope_cos"], params["rope_sin"] = model.rope_tables()
    return params


def generate(model, input_ids, max_new_tokens=32, max_length=None,
             do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
             eos_token_id=None, seed=None, weight_quant="none",
             engine="static", prefix_cache=None, spec_decode=None):
    """Autoregressive generation; returns int64 [B, prompt_len +
    n_generated] on the CPU (prompt included). engine="paged" runs the
    continuous-batching ServingEngine on the model's device; the static
    single-program engine is not ported yet."""
    cfg = model.config
    ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                     else input_ids).astype(np.int32)
    if ids.ndim == 1:
        ids = ids[None]
    if max_length is not None:
        max_new_tokens = int(max_length) - ids.shape[1]
    if max_new_tokens <= 0:
        raise ValueError("max_new_tokens must be positive")
    if engine not in ("static", "paged"):
        raise ValueError(f"engine must be 'static' or 'paged', got "
                         f"{engine!r}")
    if engine == "static":
        raise NotImplementedError(
            "the static single-program generate is not ported yet (ROADMAP "
            "Queue 1, item 5, 'The static single-program generate'); use "
            "engine='paged'")
    total = ids.shape[1] + int(max_new_tokens)
    kv_bs = int(flag("FLAGS_kv_block_size"))
    usable = (int(cfg.max_position_embeddings) // kv_bs) * kv_bs
    if total > usable:
        raise ValueError(
            f"prompt ({ids.shape[1]}) + max_new_tokens ({max_new_tokens}) "
            f"= {total} exceeds the paged engine's usable context ({usable} "
            f"= max_position_embeddings rounded down to whole {kv_bs}-token "
            "kv blocks); use a smaller generation budget")
    from ..inference.engine import generate_paged

    toks = generate_paged(model, ids.astype(np.int64), int(max_new_tokens),
                          do_sample=bool(do_sample),
                          temperature=float(temperature), top_k=int(top_k),
                          top_p=float(top_p), eos_token_id=eos_token_id,
                          seed=None if seed is None else int(seed),
                          prefix_cache=prefix_cache, spec_decode=spec_decode,
                          weight_quant=weight_quant, device=model.device)
    return _assemble_output(ids, toks, eos_token_id)


def _assemble_output(ids, toks, eos_token_id):
    """Trim columns past the point where every row finished, prepend the
    prompt."""
    if eos_token_id is not None:
        all_done = (toks == int(eos_token_id)).all(axis=0)
        if all_done.any():
            toks = toks[:, :int(np.argmax(all_done)) + 1]
    return torch.from_numpy(
        np.concatenate([ids, toks], axis=1).astype(np.int64))
