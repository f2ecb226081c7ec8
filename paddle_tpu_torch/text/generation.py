"""The LLaMA block math shared by the model and the serving engine.

Port of the helpers paddle_tpu/inference/engine.py imports from
paddle_tpu/text/generation.py: `_GenSpec`, `_rms_norm`, `_rope`,
`_rope_tables_np`, `_mm`, `_quantize_w`, `_quantize_w4`,
`_layer_forward_prefill` (also the block math of the port's training
forward, `text/models/llama.py`), `_logits` and the weight extraction
(`_repeat_kv` has no use here: the attention functions index or repeat
GQA kv heads themselves). Same arithmetic and dtype rules as the
reference; what differs is the mechanism: eager torch and a Python loop
over layers, where the reference traced one program and scanned stacked
weights. Weights are not stacked: the extracted parameter dict holds
the model's own tensors, so dense serving costs no copy of the
weights; weight-only quantization makes its packed copies once, when the
dict is extracted, and leaves the model's weights as they are.

Weight layout: the model's `nn.Linear` weights are Paddle's [in, out],
and the extracted layer dicts hold them as they are, so `_mm` is the
reference's plain `x @ w`, or `quant_matmul` over an (int8 [K, N] | packed
int4 [ceil(K/2), N], f32 scale [N]) pair made from them.

The static single-program `generate` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.flags import flag
from ..ops.flash_attention import flash_attention
from ..ops.quantized import quant_matmul, quant_matmul_raw, quantize_int4

#: the layer matmul weights that weight-only quantization stores as pairs
#: (the norms stay dense)
_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


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


def _mm(x, w, qmm=quant_matmul_raw):
    """x @ w where w is a dense [in, out] tensor or a weight-only pair
    (int8 [K, N] or packed int4 [ceil(K/2), N], scale f32 [N]); the pair's
    shape tells the two apart (`ops.quantized.quant_matmul`, whose int4
    matmul is `qmm`: the K8 wrapper unless a check passes its plain
    version)."""
    if isinstance(w, tuple):
        return quant_matmul(x, w[0], w[1], int4_matmul=qmm)
    return x @ w


def _quantize_w(w):
    """Per-output-channel symmetric int8 of a [K, N] weight: the port's
    copy of paddle_tpu's `weight_quantize_raw` rule (in f32, qmax 127).
    Returns (q int8 [K, N], scale f32 [N])."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 127.0
    q = torch.clamp(torch.round(wf / torch.clamp_min(scale, 1e-9)[None, :]),
                    -127.0, 127.0)
    return q.to(torch.int8), scale


def _quantize_w4(w):
    """Packed int4 (two nibbles per byte) with per-output-channel scales:
    (packed int8 [ceil(K/2), N], scale f32 [N])."""
    return quantize_int4(w)


def _layer_forward_prefill(x, lw, spec: _GenSpec, cos, sin,
                           attention=flash_attention,
                           qmm=quant_matmul_raw):
    """One decoder block over the full prompt: the model's forward (and
    its training step) and the serving engine's prefill. x [B, S, H];
    cos/sin [>=S, D]. Attention goes through `attention` ([B, H, S, D]
    layout, returns (o, lse)) and int4 weight matmuls through `qmm`: by
    default the differentiable flash op (K1 forward, K2 backward when a
    gradient is recorded) and the K8 wrapper, which take their plain
    versions for CPU tensors. The serving engine passes its attention
    explicitly and runs under `torch.no_grad()`, where the flash op is the
    forward kernel alone. Returns (x, (k, v)) with k/v [B, S, Hkv, D]."""
    x, kv = _attention_block(x, lw, spec, cos, sin, attention, qmm)
    return x + _mlp_block(x, lw, spec, qmm), kv


def _attention_block(x, lw, spec: _GenSpec, cos, sin,
                     attention=flash_attention, qmm=quant_matmul_raw):
    """The first half of `_layer_forward_prefill`: (x + attention of the
    input norm's output, (k, v))."""
    b, s, h = x.shape
    hn = _rms_norm(x, lw["input_ln"], spec.rms_eps)
    flat = hn.reshape(b * s, h)
    q = _mm(flat, lw["q"], qmm).reshape(b, s, spec.num_heads, spec.head_dim)
    k = _mm(flat, lw["k"], qmm).reshape(b, s, spec.num_kv_heads,
                                        spec.head_dim)
    v = _mm(flat, lw["v"], qmm).reshape(b, s, spec.num_kv_heads,
                                        spec.head_dim)
    c = cos[None, :s, None, :]
    sn = sin[None, :s, None, :]
    q = _rope(q, c, sn)
    k = _rope(k, c, sn)
    out, _ = attention(q.transpose(1, 2).contiguous(),
                       k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(), causal=True)
    out = out.transpose(1, 2)
    attn = _mm(out.reshape(b * s, spec.num_heads * spec.head_dim), lw["o"],
               qmm)
    return x + attn.reshape(b, s, h), (k, v)


def _mlp_block(x, lw, spec: _GenSpec, qmm=quant_matmul_raw):
    """The second half of `_layer_forward_prefill` without its residual
    add: the SwiGLU MLP of the post-attention norm's output."""
    b, s, h = x.shape
    hn = _rms_norm(x, lw["post_ln"], spec.rms_eps).reshape(b * s, h)
    mlp = _mm(F.silu(_mm(hn, lw["gate"], qmm)) * _mm(hn, lw["up"], qmm),
              lw["down"], qmm)
    return mlp.reshape(b, s, h)


def _logits(x, params, spec: _GenSpec, qmm=quant_matmul_raw):
    """x [B, H] -> f32 logits [B, V]. A quantized head takes f32
    activations, as the reference (int8: exactly (x_f32 @ w8_f32) * s)."""
    x = _rms_norm(x, params["final_ln"], spec.rms_eps)
    if spec.tie_embeddings:
        return x.float() @ params["embed"].float().T
    head = params["lm_head"]
    if isinstance(head, tuple):
        return _mm(x.float(), head, qmm)
    return x.float() @ head.float()


def _layer_weights(layer) -> dict:
    """One LlamaDecoderLayer's weights as the block math reads them (the
    layers' own torch tensors: the Linear weights are [in, out])."""
    at, mlp = layer.self_attn, layer.mlp
    return {"q": at.q_proj.weight._data, "k": at.k_proj.weight._data,
            "v": at.v_proj.weight._data, "o": at.o_proj.weight._data,
            "gate": mlp.gate_proj.weight._data,
            "up": mlp.up_proj.weight._data,
            "down": mlp.down_proj.weight._data,
            "input_ln": layer.input_layernorm.weight._data,
            "post_ln": layer.post_attention_layernorm.weight._data}


@torch.no_grad()
def _extract_llama(model, weight_quant="none") -> dict:
    """The serving parameter dict of a LlamaForCausalLM: its weights'
    torch tensors (no copy), a per-layer list in place of the reference's
    stacked [L, ...] arrays, and the rope tables in the model's dtype.
    weight_quant="int8"/"int4" stores the seven layer matmul weights and
    the lm_head as weight-only pairs (see `_mm`), made here, once."""
    if weight_quant not in ("none", "int8", "int4"):
        raise ValueError(f"weight_quant must be 'none', 'int8' or 'int4', "
                         f"got {weight_quant!r}")
    m = model.model
    layers = [_layer_weights(layer) for layer in m.layers]
    quant = weight_quant != "none"
    qfn = _quantize_w4 if weight_quant == "int4" else _quantize_w
    if quant:
        layers = [{k: qfn(w) if k in _QUANT_KEYS else w
                   for k, w in lw.items()} for lw in layers]
    params = {"embed": m.embed_tokens.weight._data,
              "final_ln": m.norm.weight._data, "layers": layers}
    if model.lm_head is not None:
        head = model.lm_head.weight._data
        params["lm_head"] = qfn(head) if quant else head
    params["rope_cos"], params["rope_sin"] = model.rope_tables()
    return params


def generate(model, input_ids, max_new_tokens=32, max_length=None,
             do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
             eos_token_id=None, seed=None, weight_quant="none",
             engine="static", prefix_cache=None, spec_decode=None):
    """Autoregressive generation; returns int64 [B, prompt_len +
    n_generated] on the CPU (prompt included). engine="paged" runs the
    continuous-batching ServingEngine on the model's device, and
    `prefix_cache` reaches it (None: FLAGS_prefix_cache); with the static
    engine `prefix_cache` raises ValueError. The static single-program
    engine is not ported yet."""
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
    if weight_quant in (None, "none"):
        # the serving-wide default: a per-call weight_quant= overrides it
        weight_quant = str(flag("FLAGS_weight_only_dtype"))
    if weight_quant not in ("none", "int8", "int4"):
        raise ValueError(f"weight_quant must be 'none', 'int8' or 'int4', "
                         f"got {weight_quant!r}")
    if engine == "static":
        if prefix_cache is not None:
            raise ValueError("prefix_cache applies to engine='paged' only "
                             "(the static engine holds no block pool)")
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
