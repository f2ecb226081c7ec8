"""The decoder block math shared by the models and the serving engines.

Port of the helpers paddle_tpu/inference/engine.py imports from
paddle_tpu/text/generation.py: `_GenSpec`, `_rms_norm`, `_layer_norm`,
`_rope`, `_rope_tables_np`, `_mm`, `_quantize_w4` (its `_quantize_w` is
`ops.quantized.quantize_int8`), `_layer_forward_prefill` (also the
block math of the port's LLaMA training forward, `text/models/llama.py`),
`_logits` and the weight extraction of both archs, `_extract_llama` and
`_extract_gpt` (`_repeat_kv` has no use here: the attention functions
index or repeat GQA kv heads themselves). The reference's per-site
copies of the block (`_layer_forward_decode`, `_gpt_layer_prefill`,
`_gpt_layer_decode`, the engines' paged and chunk layers, the
speculative verify and draft layers) are here one block,
`_attend_block` + `_mlp_block`, with the attention that reads each
site's cache passed in; the spec's `arch` picks LLaMA's half (RMSNorm,
q/k/v with rope, SwiGLU) or GPT's (LayerNorm, one fused qkv matmul, no
rope, exact GELU). The embedding of both is `_embed` (GPT adds its
learned positions there) and the rope tables' rows `_rope_at`. Same
arithmetic and dtype rules as the reference; what differs is the
mechanism: eager torch and a Python loop over layers, where the
reference traced one program and scanned stacked weights. Weights are
not stacked: the extracted parameter dict holds the model's own tensors,
so dense serving costs no copy of the weights; weight-only quantization
makes its packed copies once, when the dict is extracted, and leaves the
model's weights as they are.

Weight layout: the model's `nn.Linear` weights are Paddle's [in, out],
and the extracted layer dicts hold them as they are, so `_mm` is the
reference's plain `x @ w`, or `quant_matmul` over an (int8 [K, N] | packed
int4 [ceil(K/2), N], f32 scale [N]) pair made from them.

The static single-program `generate` (`_generate_static`): the
reference's one XLA program is here an eager prefill and one CUDA graph
of the dense-cache decode step per key, replayed for every step.
"""
from __future__ import annotations

import functools
import hashlib
import math
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import graphs
from ..core.flags import flag
from ..obs.costs import (extract_cost, needs_count, record_program,
                         reregister)
from ..obs.watchdog import record_compile
from ..ops.flash_attention import flash_attention
from ..ops.quantized import (quant_matmul, quant_matmul_raw, quantize_int4,
                             quantize_int8)

#: the layer matmul weights that weight-only quantization stores as pairs
#: (LLaMA's seven, GPT's four; the norms stay dense)
_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down", "qkv", "fc_in",
               "fc_out")


@dataclass(frozen=True)
class _GenSpec:
    """Static configuration of the block math. `arch` is "llama" (RMSNorm,
    rope, SwiGLU) or "gpt" (LayerNorm, learned positions, GELU; its
    `rms_eps` is the LayerNorm epsilon)."""
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float
    rms_eps: float
    tie_embeddings: bool
    arch: str = "llama"


def _spec_from_config(cfg) -> _GenSpec:
    """A LLaMA config's spec."""
    return _GenSpec(num_layers=cfg.num_hidden_layers,
                    num_heads=cfg.num_attention_heads,
                    num_kv_heads=cfg.num_key_value_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    rms_eps=cfg.rms_norm_eps,
                    tie_embeddings=bool(cfg.tie_word_embeddings))


def _spec_for(model) -> _GenSpec:
    """The spec of a model by its `_gen_arch`: GPT's as the reference's
    engine builds it (every head its own kv head, head_dim = hidden /
    heads, the LayerNorm epsilon, an untied head). The one reader of
    `_gen_arch`: everything after it asks the spec's `arch`."""
    cfg = model.config
    if getattr(model, "_gen_arch", "llama") == "gpt":
        nh = cfg.num_attention_heads
        return _GenSpec(num_layers=cfg.num_hidden_layers, num_heads=nh,
                        num_kv_heads=nh, head_dim=cfg.hidden_size // nh,
                        rope_theta=0.0, rms_eps=cfg.layer_norm_eps,
                        tie_embeddings=False, arch="gpt")
    return _spec_from_config(cfg)


def _rms_norm(x, w, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _layer_norm(x, w, b, eps):
    """The reference's serving LayerNorm composition: mean and variance in
    f32, the normalized value cast to the model dtype, then `* w + b` in
    the model dtype (plain torch, as the reference composes it in XLA on
    this path; the training model's LayerNorm is the fused kernel)."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf - m).square().mean(dim=-1, keepdim=True)
    return ((xf - m) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _embed(params, spec, ids, pos=None):
    """The token embeddings of `ids` [...]; GPT adds its learned position
    rows at `pos` (broadcast against ids; None: 0..S-1 along ids' last
    axis), gathered at positions clamped to the table, as JAX clamps an
    out-of-range gather (padded bucket rows, verify windows at the
    context's end and trash rows reach past it; their outputs are never
    read, and on a card an unclamped gather would assert)."""
    x = params["embed"][ids]
    if spec.arch != "gpt":
        return x
    wpe = params["wpe"]
    if pos is None:
        pos = torch.arange(ids.shape[-1], device=ids.device)
    return x + wpe[torch.clamp(pos, 0, wpe.shape[0] - 1)]


def _rope_full(params, spec):
    """LLaMA's whole rope tables (cos, sin) [T, D], as a full-prompt
    forward takes them; (None, None) for GPT, which has no rope."""
    if spec.arch == "gpt":
        return None, None
    return params["rope_cos"], params["rope_sin"]


def _rope_at(params, spec, pos):
    """LLaMA's cos/sin rows at positions `pos` (clamped to the table),
    shaped [*pos.shape, 1, D] to broadcast against [..., heads, D];
    (None, None) for GPT, which has no rope."""
    cos, sin = _rope_full(params, spec)
    if cos is None:
        return None, None
    p = torch.clamp(pos, 0, cos.shape[0] - 1)
    return cos[p][..., None, :], sin[p][..., None, :]


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
    s = x.shape[1]
    kv = []

    def attend(q, k, v):
        kv.append((k, v))
        out, _ = attention(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), causal=True)
        return out.transpose(1, 2)

    if cos is not None:
        cos, sin = cos[None, :s, None], sin[None, :s, None]
    x = _attend_block(x, lw, spec, cos, sin, attend, qmm)
    return x, kv[0]


def _attend_block(x, lw, spec: _GenSpec, cos, sin, attend,
                  qmm=quant_matmul_raw):
    """x + the attention half of a decoder block, over the rows of x
    [..., H] (a prompt's [B, S, H], a verify window's [B, C, H], a chunk's
    [C, H], a decode step's [B, H]): the input norm, Q/K/V, rope with
    cos/sin broadcast against [..., heads, D], then `attend(q, k, v)` —
    which stores the block's k/v where its caller keeps them and returns
    the attended values [..., Hq, D] — and the o-projection. GPT (the
    spec's arch): the LayerNorm ln_1, one fused qkv matmul reshaped to
    [..., 3, heads, D] and split on that axis, no rope (cos/sin None).
    Every block of the models, the engines and the speculative programs
    is this and `_mlp_block`; they differ only in `attend`."""
    lead, h = x.shape[:-1], x.shape[-1]
    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if spec.arch == "gpt":
        hn = _layer_norm(x, lw["ln1_w"], lw["ln1_b"],
                         spec.rms_eps).reshape(-1, h)
        q, k, v = _mm(hn, lw["qkv"], qmm).reshape(*lead, 3, nh,
                                                  hd).unbind(-3)
    else:
        hn = _rms_norm(x, lw["input_ln"], spec.rms_eps).reshape(-1, h)
        q = _rope(_mm(hn, lw["q"], qmm).reshape(*lead, nh, hd), cos, sin)
        k = _rope(_mm(hn, lw["k"], qmm).reshape(*lead, nkv, hd), cos, sin)
        v = _mm(hn, lw["v"], qmm).reshape(*lead, nkv, hd)
    out = attend(q, k, v)
    return x + _mm(out.reshape(-1, nh * hd), lw["o"], qmm).reshape(x.shape)


def _mlp_block(x, lw, spec: _GenSpec, qmm=quant_matmul_raw):
    """The second half of a decoder block without its residual add: the
    SwiGLU MLP of the post-attention norm's output, over x [..., H]; GPT:
    fc_out of the exact GELU (in the model dtype) of fc_in of ln_2's
    output."""
    h = x.shape[-1]
    if spec.arch == "gpt":
        hn = _layer_norm(x, lw["ln2_w"], lw["ln2_b"],
                         spec.rms_eps).reshape(-1, h)
        mlp = _mm(F.gelu(_mm(hn, lw["fc_in"], qmm), approximate="none"),
                  lw["fc_out"], qmm)
        return mlp.reshape(x.shape)
    hn = _rms_norm(x, lw["post_ln"], spec.rms_eps).reshape(-1, h)
    mlp = _mm(F.silu(_mm(hn, lw["gate"], qmm)) * _mm(hn, lw["up"], qmm),
              lw["down"], qmm)
    return mlp.reshape(x.shape)


def _cached_block(x, lw, spec: _GenSpec, cos, sin, attend,
                  qmm=quant_matmul_raw):
    """One decoder block whose attention `attend` reads a cache (see
    `_attend_block`): the serving engine's decode, chunk and verify
    steps, the static engine's step and the speculative programs."""
    x = _attend_block(x, lw, spec, cos, sin, attend, qmm)
    return x + _mlp_block(x, lw, spec, qmm)


def _dense_attention(q, k, v, valid):
    """Masked attention of q [B, C, Hq, D] over dense k/v [B, T, Hkv, D]
    (each kv head serving its group of query heads in place, no repeated
    copy), where `valid` (broadcast to [B, C, T]) marks the keys each
    query sees: scores in the model dtype, the softmax in f32, as the
    reference's compositions. Returns [B, C, Hq, D]."""
    b, c, hq, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, c, g, hq // g, d)
    scores = torch.einsum("bcgrd,btgd->bgrct", qg, k.to(q.dtype)) \
        * (1.0 / math.sqrt(d))
    scores = torch.where(valid[:, None, None], scores,
                         torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bgrct,btgd->bcgrd", probs, v.to(q.dtype))
    return out.reshape(b, c, hq, d)


def _logits(x, params, spec: _GenSpec, qmm=quant_matmul_raw):
    """x [B, H] -> f32 logits [B, V]: the final norm (GPT's LayerNorm
    ln_f), then the head. A quantized head takes f32 activations, as the
    reference (int8: exactly (x_f32 @ w8_f32) * s)."""
    if spec.arch == "gpt":
        x = _layer_norm(x, params["final_ln"], params["final_ln_b"],
                        spec.rms_eps)
    else:
        x = _rms_norm(x, params["final_ln"], spec.rms_eps)
    if spec.tie_embeddings:
        return x.float() @ params["embed"].float().T
    head = params["lm_head"]
    if isinstance(head, tuple):
        return _mm(x.float(), head, qmm)
    return x.float() @ head.float()


# ------------------------------------------------------------- sampling

def _filter_logits(logits, temperature, top_k, top_p):
    """The (temperature, top-k, top-p) logit filter over [B, V] with the
    sampling params as batched tensors — top-k before top-p, as the
    reference."""
    v = logits.shape[-1]
    lg = logits.float() / temperature.clamp_min(1e-6)[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    lg = torch.where((top_k > 0)[:, None] & (lg < kth), float("-inf"), lg)
    srt2 = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(srt2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]
    cutoff = torch.where(keep, srt2, float("inf")).min(
        dim=-1, keepdim=True).values
    return torch.where((top_p < 1.0)[:, None] & (lg < cutoff), float("-inf"),
                       lg)


def _sample_batched(logits, generator, do_sample, temperature, top_k, top_p):
    """Per-row (greedy | temperature/top-k/top-p) sampling over [B, V];
    greedy rows are an exact argmax. Sampled rows draw by Gumbel-max from
    `generator`."""
    greedy = logits.argmax(dim=-1)
    sampled = _categorical(_filter_logits(logits, temperature, top_k, top_p),
                           generator)
    return torch.where(do_sample, sampled, greedy)


def _categorical(lg, generator):
    """One draw per row of [..., V] logits by Gumbel-max from
    `generator`."""
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (lg + gumbel).argmax(dim=-1)


#: a sampling program's per-row inputs, as `_sample_batched` takes them
_SAMP_KEYS = ("do_sample", "temperature", "top_k", "top_p")


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


def _quantizer(weight_quant):
    """The weight-only quantizer of `weight_quant` (None for "none")."""
    if weight_quant not in ("none", "int8", "int4"):
        raise ValueError(f"weight_quant must be 'none', 'int8' or 'int4', "
                         f"got {weight_quant!r}")
    if weight_quant == "none":
        return None
    return _quantize_w4 if weight_quant == "int4" else quantize_int8


def _quantize_layers(layers, qfn):
    return layers if qfn is None else [
        {k: qfn(w) if k in _QUANT_KEYS else w for k, w in lw.items()}
        for lw in layers]


@torch.no_grad()
def _extract_llama(model, weight_quant="none") -> dict:
    """The serving parameter dict of a LlamaForCausalLM: its weights'
    torch tensors (no copy), a per-layer list in place of the reference's
    stacked [L, ...] arrays, and the rope tables in the model's dtype.
    weight_quant="int8"/"int4" stores the seven layer matmul weights and
    the lm_head as weight-only pairs (see `_mm`), made here, once."""
    qfn = _quantizer(weight_quant)
    m = model.model
    layers = _quantize_layers([_layer_weights(layer) for layer in m.layers],
                              qfn)
    params = {"embed": m.embed_tokens.weight._data,
              "final_ln": m.norm.weight._data, "layers": layers}
    if model.lm_head is not None:
        head = model.lm_head.weight._data
        params["lm_head"] = head if qfn is None else qfn(head)
    params["rope_cos"], params["rope_sin"] = model.rope_tables()
    return params


@torch.no_grad()
def _extract_gpt(model, weight_quant="none") -> dict:
    """The serving parameter dict of a GPTForCausalLM, read by the
    reference's state-dict names (`_extract_gpt` there): wte, wpe, ln_f,
    the untied lm_head and per block ln_1, attn.qkv_proj, attn.out_proj,
    ln_2, fc_in, fc_out — the model's own tensors, no copy. With
    weight_quant="int8"/"int4" qkv, o, fc_in, fc_out and the head are
    weight-only pairs, made here, once."""
    qfn = _quantizer(weight_quant)
    sd = model.state_dict()

    def w(name):
        return sd[name]._data

    layers = []
    for i in range(model.config.num_hidden_layers):
        base = f"blocks.{i}."
        layers.append({"ln1_w": w(base + "ln_1.weight"),
                       "ln1_b": w(base + "ln_1.bias"),
                       "qkv": w(base + "attn.qkv_proj.weight"),
                       "o": w(base + "attn.out_proj.weight"),
                       "ln2_w": w(base + "ln_2.weight"),
                       "ln2_b": w(base + "ln_2.bias"),
                       "fc_in": w(base + "fc_in.weight"),
                       "fc_out": w(base + "fc_out.weight")})
    head = w("lm_head.weight")
    return {"embed": w("wte.weight"), "wpe": w("wpe.weight"),
            "final_ln": w("ln_f.weight"), "final_ln_b": w("ln_f.bias"),
            "lm_head": head if qfn is None else qfn(head),
            "layers": _quantize_layers(layers, qfn)}


def _extract(model, spec, weight_quant="none") -> dict:
    """The serving parameter dict of a LLaMA or GPT model (`spec`, its
    `_spec_for`, says which)."""
    if spec.arch == "gpt":
        return _extract_gpt(model, weight_quant)
    return _extract_llama(model, weight_quant)


def _tensors(tree):
    """Every tensor of a nest of dicts, lists and tuples (a serving
    parameter dict)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


# --------------------------------------------------------- static engine

class _StaticProgram:
    """The static engine's program for one key (`_program_key`): the
    static cache [L, B, total, Hkv, D] (the reference's padded K/V), the
    decode state on the device (`tok`, `pos`, `finished`, the step `i` and
    the tokens `toks` [B, G]), the sampling rows and generator, and on a
    card the CUDA graph of one decode step, captured at the key's first
    generate and replayed G - 1 times by every generate of the key."""

    def __init__(self, spec, params, b, total, g, samp, eos, device):
        dtype = params["embed"].dtype
        shape = (spec.num_layers, b, total, spec.num_kv_heads,
                 spec.head_dim)
        self.spec, self.params, self.eos = spec, params, int(eos)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.tok = torch.zeros(b, dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)
        self.i = torch.zeros(1, dtype=torch.long, device=device)
        self.finished = torch.zeros(b, dtype=torch.bool, device=device)
        self.toks = torch.zeros((b, g), dtype=torch.long, device=device)
        self.gen = torch.Generator(device=device)
        do_sample, temperature, top_k, top_p = samp
        self.samp = None if not do_sample else (
            torch.ones(b, dtype=torch.bool, device=device),
            torch.full((b,), temperature, dtype=torch.float32,
                       device=device),
            torch.full((b,), top_k, dtype=torch.int32, device=device),
            torch.full((b,), top_p, dtype=torch.float32, device=device))
        self.graph = None
        self.capture_s = 0.0
        # the cost of one decode step (counted at the capture's dry run,
        # or the first eager step) and the program's cost-ledger row
        self.step_cost = None
        self.entry = None

    def pick(self, logits):
        if self.samp is None:
            return logits.argmax(dim=-1)
        return _sample_batched(logits, self.gen, *self.samp)

    @torch.no_grad()
    def prefill(self, ids, true_len):
        """The prompt [B, bucket] through every layer (K1 on a card), its
        K/V into the cache's first `bucket` positions, the first token
        from the logits at true_len - 1 (padded positions write garbage
        K/V at [true_len, bucket), which decode overwrites before its mask
        reaches them), and the decode state reset."""
        spec, params = self.spec, self.params
        x = _embed(params, spec, ids)
        cos, sin = _rope_full(params, spec)
        s = ids.shape[1]
        for li, lw in enumerate(params["layers"]):
            x, (k, v) = _layer_forward_prefill(x, lw, spec, cos, sin)
            self.k[li, :, :s].copy_(k)
            self.v[li, :, :s].copy_(v)
        tok0 = self.pick(_logits(x[:, true_len - 1], params, spec))
        self.tok.copy_(tok0)
        self.toks[:, 0] = tok0
        self.finished.copy_(tok0 == self.eos)
        self.pos.fill_(true_len)
        self.i.fill_(1)

    @torch.no_grad()
    def step(self):
        """One decode step on the static buffers, in place: consume `tok`
        at `pos`, pick the next token (eos once finished) into `toks[:,
        i]`, advance `pos` and `i`."""
        spec, params, pos = self.spec, self.params, self.pos
        x = _embed(params, spec, self.tok, pos)               # [B, H]
        cos, sin = _rope_at(params, spec, pos)                # [1, 1, D]
        valid = (torch.arange(self.k.shape[2], device=pos.device)
                 <= pos)[None, None]                          # [1, 1, T]

        def attend(li, q, k, v):
            # the reference's dense-cache step: write at pos, mask
            # arange(T) <= pos
            kc, vc = self.k[li], self.v[li]
            kc.index_copy_(1, pos, k[:, None])
            vc.index_copy_(1, pos, v[:, None])
            return _dense_attention(q[:, None], kc, vc, valid)[:, 0]

        for li, lw in enumerate(params["layers"]):
            x = _cached_block(x, lw, spec, cos, sin,
                              functools.partial(attend, li))
        nxt = self.pick(_logits(x, params, spec))
        nxt = torch.where(self.finished, self.eos, nxt)
        self.finished |= nxt == self.eos
        self.toks.index_copy_(1, self.i, nxt[:, None])
        self.tok.copy_(nxt)
        self.pos += 1
        self.i += 1

    def capture(self, count=False):
        """Capture `step` into a CUDA graph on the device's side stream.
        The dry run before it (with `count`, under the cost counter:
        `step_cost`) is a real step on the live state, whose small parts
        (and the generator) are put back afterwards; its cache write at
        `pos` is the one the first replay makes again."""
        small = (self.tok, self.pos, self.i, self.finished, self.toks)
        saved = [t.clone() for t in small]
        gen_state = self.gen.get_state()

        def dry_run():
            if count:
                self.step_cost, _ = extract_cost(self.step, self.k.device)
            else:
                self.step()
            for t, v in zip(small, saved):
                t.copy_(v)
            self.gen.set_state(gen_state)

        stream = graphs.side_stream(self.k.device)
        pool = torch.cuda.graph_pool_handle()
        self.graph = graphs.capture(
            self.step, stream, pool,
            () if self.samp is None else (self.gen,), dry_run)
        self.capture_s = self.graph.capture_s

    def decode(self, n):
        """n decode steps: graph replays on a card, the step itself
        elsewhere. Nothing is read back."""
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.step()


#: per model (weakly held): {weight_quant: (weights fingerprint, params,
#: {program key: _StaticProgram})}. A graph holds the addresses of its
#: params and buffers, so programs live beside the params they read; a
#: changed weight (a new tensor, or one written in place) re-extracts and
#: drops them
_STATIC: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: static programs kept per (model, weight_quant), the newest first
_STATIC_MAX_PROGRAMS = 4


def _weights_fingerprint(model):
    return tuple((t._data.data_ptr(), t._data._version)
                 for t in model.parameters())


def _static_entry(model, weight_quant):
    """(params, programs) of `model` at `weight_quant`, extracted once
    per state of its weights."""
    per_model = _STATIC.setdefault(model, {})
    fp = _weights_fingerprint(model)
    hit = per_model.get(weight_quant)
    if hit is None or hit[0] != fp:
        hit = (fp, _extract(model, _spec_for(model), weight_quant), {})
        per_model[weight_quant] = hit
    return hit[1], hit[2]


def static_program_stats(model) -> dict:
    """The static programs held for `model`: their keys' count, graphs
    captured and the capture wall seconds."""
    progs = [p for _, _, d in _STATIC.get(model, {}).values()
             for p in d.values()]
    return {"programs": len(progs),
            "graphs": sum(p.graph is not None for p in progs),
            "capture_s": sum(p.capture_s for p in progs)}


def _generate_static(model, ids, mnt, do_sample, temperature, top_k, top_p,
                     eos_token_id, seed, weight_quant):
    """The static single-program engine (the reference's `_generate_program`
    and the static branch of its `generate`): the prompt padded to its
    bucket, the generation length bucketed (bounded by the positions left
    after the prompt), a prefill, then G - 1 decode steps replayed from
    one CUDA graph per key with the tokens read back once. A key's first
    generate is the compile event of the obs watchdog (site "generate",
    group "generate/<arch>"), with the capture wall on a card and the
    eager first call's wall elsewhere. Returns int64 [B, mnt] on the
    CPU."""
    from ..jit.api import default_buckets

    cfg = model.config
    max_pos = int(cfg.max_position_embeddings)
    b, s_true = ids.shape
    g = max(min(default_buckets(mnt), max_pos - s_true), mnt)
    bucket = max(min(default_buckets(s_true), max_pos - g), s_true)
    spec = _spec_for(model)
    params, programs = _static_entry(model, weight_quant)
    eos = int(eos_token_id if eos_token_id is not None else -1)
    samp = (bool(do_sample), float(temperature), int(top_k), float(top_p))
    params_fp = tuple((tuple(t.shape), str(t.dtype))
                      for t in _tensors(params))
    key = (spec, b, bucket, g) + samp + (eos, weight_quant, params_fp)
    prog = programs.pop(key, None)
    device = model.device
    first = prog is None
    if first:
        prog = _StaticProgram(spec, params, b, bucket + g, g, samp, eos,
                              device)
    programs[key] = prog                      # newest last
    while len(programs) > _STATIC_MAX_PROGRAMS:
        programs.pop(next(iter(programs)))
    if seed is None:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,)).item())
    prog.gen.manual_seed(int(seed))
    ids_p = np.zeros((b, bucket), np.int64)
    ids_p[:, :s_true] = ids
    key_str = (f"b{b}/s{bucket}/g{g}/sample{int(samp[0])}/p"
               + hashlib.sha1(repr(params_fp).encode()).hexdigest()[:8])
    count = first and needs_count("generate", key_str)
    t0 = time.perf_counter()
    ids_t = torch.from_numpy(ids_p).to(device)
    pre = None
    if count:
        # the cost ledger counts the key's eager runs: the prefill and
        # one decode step (the capture's dry run on a card, the first
        # step elsewhere), a program of one prefill and g - 1 steps
        pre, _ = extract_cost(lambda: prog.prefill(ids_t, s_true), device,
                              args=(ids_t,))
    else:
        prog.prefill(ids_t, s_true)
    if g > 1 and prog.graph is None and device.type == "cuda":
        prog.capture(count)
    if count and g > 1 and prog.graph is None:
        prog.step_cost, _ = extract_cost(prog.step, device)
        prog.decode(g - 2)
    else:
        prog.decode(g - 1)
    toks = prog.toks.cpu().numpy()[:, :mnt]
    wall = time.perf_counter() - t0
    if first:
        compile_wall = prog.capture_s if device.type == "cuda" else wall
        prog.entry = record_program(
            "generate", f"generate/{spec.arch}", key_str,
            cost=_program_cost(pre, prog.step_cost, g - 1, prog.toks),
            wall_s=compile_wall, bucket=bucket)
        record_compile("generate", f"generate/{spec.arch}", key_str,
                       bucket=(bucket, g), wall_s=compile_wall,
                       cost=prog.entry.cost_summary())
        # the call's wall net of its capture, as the reference observes
        # a generate's execution apart from its compile
        wall -= prog.capture_s
    else:
        reregister(prog.entry)
    prog.entry.observe(wall)
    return toks


def _program_cost(prefill, step, steps, toks):
    """The static program's counted cost: the prefill's plus `steps` decode
    steps' (None when either was not counted)."""
    if prefill is None or (steps and step is None):
        return None
    step = step or {}
    return {"flops": prefill["flops"] + steps * step.get("flops", 0.0),
            "bytes_accessed": prefill["bytes_accessed"]
            + steps * step.get("bytes_accessed", 0.0),
            "arg_bytes": prefill["arg_bytes"],
            "out_bytes": toks.numel() * toks.element_size(),
            "temp_bytes": max(prefill["temp_bytes"],
                              step.get("temp_bytes", 0)),
            "peak_hbm_bytes": max(prefill["peak_hbm_bytes"],
                                  step.get("peak_hbm_bytes", 0))}


def generate(model, input_ids, max_new_tokens=32, max_length=None,
             do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
             eos_token_id=None, seed=None, weight_quant="none",
             engine="static", prefix_cache=None, spec_decode=None):
    """Autoregressive generation; returns int64 [B, prompt_len +
    n_generated] on the CPU (prompt included).

    engine="static" (the default) is the single-program engine: a prefill
    (K1 on a card), then every decode step replayed from one CUDA graph
    per (batch, prompt bucket, generation bucket, sampling config, weight
    shapes), the tokens read back once. engine="paged" runs the
    continuous-batching ServingEngine on the model's device, and
    `prefix_cache` reaches it (None: FLAGS_prefix_cache); with the static
    engine `prefix_cache` raises ValueError. `spec_decode` turns on
    speculative decoding (inference/speculative.py): forwarded to the
    ServingEngine for engine="paged"; on the static engine greedy, the
    n-gram proposer and unquantized weights only. Tokens stay identical
    to the non-speculative run either way. LLaMA and GPT models (their
    `_gen_arch`) take every path."""
    cfg = model.config
    ids = getattr(input_ids, "_data", input_ids)
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids).astype(
        np.int32)
    if ids.ndim == 1:
        ids = ids[None]
    if max_length is not None:
        max_new_tokens = int(max_length) - ids.shape[1]
    if max_new_tokens <= 0:
        raise ValueError("max_new_tokens must be positive")
    total = ids.shape[1] + int(max_new_tokens)
    if total > int(cfg.max_position_embeddings):
        # the position tables (rope, wpe) end here
        raise ValueError(
            f"prompt ({ids.shape[1]}) + max_new_tokens ({max_new_tokens}) "
            f"= {total} exceeds max_position_embeddings "
            f"({cfg.max_position_embeddings})")
    if engine not in ("static", "paged"):
        raise ValueError(f"engine must be 'static' or 'paged', got "
                         f"{engine!r}")
    if weight_quant in (None, "none"):
        # the serving-wide default: a per-call weight_quant= overrides it
        weight_quant = str(flag("FLAGS_weight_only_dtype"))
    if weight_quant not in ("none", "int8", "int4"):
        raise ValueError(f"weight_quant must be 'none', 'int8' or 'int4', "
                         f"got {weight_quant!r}")
    mnt = int(max_new_tokens)
    if engine == "paged":
        kv_bs = int(flag("FLAGS_kv_block_size"))
        usable = (int(cfg.max_position_embeddings) // kv_bs) * kv_bs
        if total > usable:
            raise ValueError(
                f"prompt ({ids.shape[1]}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds the paged engine's "
                f"usable context ({usable} = max_position_embeddings "
                f"rounded down to whole {kv_bs}-token kv blocks); use "
                "engine='static' or a smaller generation budget")
        from ..inference.engine import generate_paged

        toks = generate_paged(model, ids.astype(np.int64), mnt,
                              do_sample=bool(do_sample),
                              temperature=float(temperature),
                              top_k=int(top_k), top_p=float(top_p),
                              eos_token_id=eos_token_id,
                              seed=None if seed is None else int(seed),
                              prefix_cache=prefix_cache,
                              spec_decode=spec_decode,
                              weight_quant=weight_quant, device=model.device)
        return _assemble_output(ids, toks, eos_token_id)
    if prefix_cache is not None:
        raise ValueError("prefix_cache applies to engine='paged' only "
                         "(the static engine holds no block pool)")
    if spec_decode not in (None, "off"):
        if do_sample:
            raise NotImplementedError(
                "static-engine speculative decoding is greedy-only; "
                "rejection sampling rides engine='paged'")
        if weight_quant != "none":
            raise NotImplementedError(
                "static-engine speculative decoding runs unquantized "
                "weights")
        from ..inference.speculative import SpecConfig, generate_static_spec

        sc = spec_decode if isinstance(spec_decode, SpecConfig) \
            else SpecConfig(method=str(spec_decode))
        if sc.method != "ngram" or sc.proposer is not None:
            raise NotImplementedError(
                "the static engine wires the n-gram proposer only; "
                "draft-model speculation rides engine='paged'")
        toks = generate_static_spec(model, ids, mnt,
                                    eos_token_id=eos_token_id, k=sc.k,
                                    max_ngram=sc.max_ngram)
        return _assemble_output(ids, toks, eos_token_id)
    toks = _generate_static(model, ids, mnt, do_sample, temperature, top_k,
                            top_p, eos_token_id, seed, weight_quant)
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
