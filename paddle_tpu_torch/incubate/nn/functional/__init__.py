"""paddle.incubate.nn.functional: the fused-op API.

Port of paddle_tpu/incubate/nn/functional/__init__.py. Every function
takes and returns the Tensor API's `Tensor` (or torch tensors) and runs
on the torch tensors beneath.

- The kernel paths: `fused_rms_norm` and `fused_layer_norm` (with a
  `residual`, the add fused into the norm: (out, summed)), `swiglu`,
  `fused_rotary_position_embedding` (neox style) and `fused_dropout_add`
  go through `nn.functional`'s gates to K3, K3-LN, K5, K4 and K6 (one
  launch a call on a CUDA tensor with `FLAGS_pallas_fused_ops` on; their
  plain versions on the CPU), as the reference's reach its Pallas
  kernels.
- The reference's XLA compositions are plain torch: `fused_linear`,
  `fused_bias_act`, `fused_matmul_bias`, `fused_linear_activation`,
  `fused_bias_dropout_residual_layer_norm`, `fused_feedforward`,
  `fused_moe` (every expert on every token, the top-k gate selecting),
  `masked_multihead_attention` (one decode step over a dense cache),
  `blha_get_max_len`, `block_multihead_attention` (the decode step over
  block tables), `variable_length_memory_efficient_attention` (a dense
  mask) and `fused_multi_transformer` (the layer loop).
- `memory_efficient_attention` is the flash route (K1v / K2v with
  `cu_seqlens`, else `scaled_dot_product_attention`), and
  `fused_linear_cross_entropy` the chunked loss (`fused_loss.py`).
- The quantization functions: `weight_quantize`, `weight_quantize_raw`
  and `weight_dequantize` (int8 and packed int4, `ops.quantized`'s
  rules), `weight_only_linear` (`quant_matmul`: K8 for per-channel int4
  on a card) and `llm_int8_linear` (int8 x int8 -> int32 through
  cuBLASLt on a card).
- `fused_multi_head_attention` raises, as the reference's does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....core.dispatch import boundary, op
from ....core.dtype import convert_dtype
from ....ops.quantized import (dequant_int4, int8_matmul, quant_linear,
                               quantize_int4, quantize_int8)
from ....nn import functional as F
from ....nn.functional import fused_dropout_add  # noqa: F401  (K6)
from .fused_loss import (fused_linear_cross_entropy,  # noqa: F401
                         fused_linear_cross_entropy_reference)

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "swiglu",
    "fused_rotary_position_embedding", "fused_dropout_add", "fused_linear",
    "fused_bias_act", "fused_multi_head_attention",
    "fused_matmul_bias", "fused_linear_activation",
    "fused_bias_dropout_residual_layer_norm", "fused_feedforward",
    "fused_moe", "masked_multihead_attention", "blha_get_max_len",
    "block_multihead_attention", "variable_length_memory_efficient_attention",
    "fused_multi_transformer",
]


# ------------------------------------------------------------ kernel paths
@boundary
def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                   begin_norm_axis=-1, residual=None, **kw):
    """(out, None); with `residual`, (rmsnorm(x + residual), x +
    residual) in one K3 launch."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            "fused_rms_norm normalizes the last axis (begin_norm_axis=-1)")
    if residual is not None:
        out, summed = F.fused_add_rms_norm(x, residual, norm_weight,
                                           epsilon=epsilon)
        if norm_bias is not None:
            out = out + norm_bias
        return out, summed
    out = F.rms_norm(x, norm_weight, epsilon=epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return out, None


@boundary
def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, residual=None, **kw):
    """(out, None, None) over the axes from `begin_norm_axis` on; with
    `residual`, (ln(x + residual), x + residual) in one K3-LN launch."""
    if residual is not None:
        if begin_norm_axis not in (-1, x.dim() - 1):
            raise NotImplementedError(
                "fused_layer_norm(residual=...) normalizes the last axis "
                "(begin_norm_axis=-1)")
        return F.fused_add_layer_norm(x, residual, norm_weight, norm_bias,
                                      epsilon=epsilon)
    return F.layer_norm(x, x.shape[begin_norm_axis:], weight=norm_weight,
                        bias=norm_bias, epsilon=epsilon), None, None


def swiglu(x, y=None):
    """silu(x) * y (K5); with y None, x's last axis halves."""
    return F.swiglu(x, y)


@boundary
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Neox rotary on q and k (one K4 launch for both when they have one
    shape); v passes through. Returns (q, k, v), (q, k) or (q,), as the
    reference's."""
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "fused_rotary_position_embedding: interleaved (GPT-J) rotary "
            "style is not implemented; use_neox_rotary_style=True only")
    if position_ids is not None:
        raise NotImplementedError(
            "fused_rotary_position_embedding: gather the cos/sin tables by "
            "position_ids before the call (the generation engine does)")
    if sin is None or cos is None:
        raise ValueError("fused_rotary_position_embedding needs sin AND cos")
    qo, ko = F.rotary_position_embedding(q, k, cos, sin)
    if v is not None:
        return qo, ko, v
    return (qo, ko) if k is not None else (qo,)


# ------------------------------------------------- compositions (plain torch)
@boundary
def fused_linear(x, weight, bias=None, transpose_weight=False):
    if transpose_weight:
        weight = weight.T
    return F.linear(x, weight, bias)


@boundary
def fused_bias_act(x, bias=None, act_method="gelu"):
    if bias is not None:
        x = x + bias
    return getattr(F, act_method)(x)


def fused_multi_head_attention(*args, **kwargs):
    raise NotImplementedError(
        "fused_multi_head_attention: use "
        "paddle_tpu_torch.nn.functional.scaled_dot_product_attention (the "
        "flash kernels) — the fused QKV+attention+proj megakernel is not "
        "part of the API, as in the reference")


@boundary
def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """matmul(x, y) + bias (cuBLAS; the reference's XLA fuses the add)."""
    from ....ops.linalg import matmul

    out = matmul(x, y, transpose_x, transpose_y)
    return out + bias if bias is not None else out


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    if activation in ("none", None, ""):
        return out
    return getattr(F, activation)(out)


@boundary
def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode='upscale_in_train',
                                           name=None):
    """layer_norm(residual + dropout(x + bias))."""
    if bias is not None:
        x = x + bias
    y = F.dropout(x, p=dropout_rate, training=training, mode=mode) + residual
    return F.layer_norm(y, y.shape[-1:], weight=ln_scale, bias=ln_bias,
                        epsilon=ln_epsilon)


@boundary
def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode='upscale_in_train', name=None):
    """The transformer FFN block: [layer_norm], linear, activation,
    dropout, linear, dropout, the residual add[, layer_norm]."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    h = getattr(F, activation)(F.linear(x, linear1_weight, linear1_bias))
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = F.dropout(F.linear(h, linear2_weight, linear2_bias),
                  p=dropout2_rate, training=training, mode=mode)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], weight=ln2_scale,
                           bias=ln2_bias, epsilon=ln2_epsilon)
    return out


@op("fused_moe")
def _fused_moe(x, gate_weight, ffn1, ffn2, b1, b2, moe_topk,
               norm_topk_prob):
    probs = torch.softmax(x @ gate_weight, dim=-1)            # [..., E]
    # the top k, ties to the lowest expert first (jax's top_k)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    topi = order[..., :moe_topk]
    topv = probs.gather(-1, topi)
    if norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(len(ffn1)):
        h = x @ ffn1[e]
        if b1 is not None:
            h = h + b1[e]
        h = torch.nn.functional.gelu(h, approximate="tanh") @ ffn2[e]
        if b2 is not None:
            h = h + b2[e]
        w = torch.where(topi == e, topv, 0.0).sum(-1, keepdim=True)
        out = out + w * h
    return out


def fused_moe(x, gate_weight, ffn1_weights, ffn2_weights, ffn1_biases=None,
              ffn2_biases=None, moe_topk=2, norm_topk_prob=True, name=None):
    """Top-k gated mixture of GELU expert FFNs, dense: every expert runs
    on every token and the gate's top k weigh them (jax's `gelu`, the
    tanh form, as the reference's)."""
    return _fused_moe(x, gate_weight, list(ffn1_weights),
                      list(ffn2_weights),
                      None if ffn1_biases is None else list(ffn1_biases),
                      None if ffn2_biases is None else list(ffn2_biases),
                      moe_topk, norm_topk_prob)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype='default', name=None):
    """One decode step with a dense KV cache: x [B, 3*H*D] the packed
    qkv of the step, cache_kv [2, B, H, MaxLen, D], sequence_lengths [B]
    the position each row writes. Returns (out [B, H*D], the cache with
    the step's k and v written)."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    if qkv_out_scale is not None or out_shift is not None:
        raise NotImplementedError(
            "masked_multihead_attention int8 dequant path (qkv_out_scale/"
            "out_shift): use quantization.ptq QuantizedLinear for int8")
    if beam_cache_offset is not None:
        raise NotImplementedError(
            "masked_multihead_attention beam search cache offsets")
    if rotary_tensor is not None or rotary_emb_dims:
        raise NotImplementedError(
            "masked_multihead_attention external rotary_tensor: the "
            "generation engine (text/generation.py) applies RoPE from the "
            "model config; pre-rotate q/k before calling this op")
    if int(seq_len) != 1:
        raise ValueError("masked_multihead_attention decodes ONE step "
                         f"(seq_len=1), got {seq_len}")
    if sequence_lengths is None:
        raise ValueError(
            "masked_multihead_attention needs sequence_lengths (the current "
            "decode position per batch row): the function cannot infer "
            "the timestep from cache_kv")
    return _masked_mha(x, cache_kv, bias, src_mask, sequence_lengths,
                       compute_dtype)


@op("masked_multihead_attention")
def _masked_mha(x, cache, bias, src_mask, lens, compute_dtype):
    from ....core.dtype import convert_dtype

    if compute_dtype not in ("default", None):
        x = x.to(convert_dtype(compute_dtype))
    b = x.shape[0]
    nh, length, dh = cache.shape[2], cache.shape[3], cache.shape[4]
    qkv = x.reshape(b, 3, nh, dh)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, nh, dh).to(qkv.dtype)
    pos = lens.reshape(b).long()
    q, k, v = qkv.unbind(1)                                    # [B, H, D]
    at = (torch.arange(length, device=x.device)[None, :]
          == pos[:, None])[:, None, :, None]                   # [B,1,L,1]
    keys = torch.where(at, k[:, :, None, :].to(cache.dtype), cache[0])
    vals = torch.where(at, v[:, :, None, :].to(cache.dtype), cache[1])
    scores = torch.einsum("bhd,bhld->bhl", q, keys) / torch.sqrt(
        torch.tensor(float(dh), dtype=x.dtype, device=x.device))
    seen = torch.arange(length, device=x.device)[None, None, :] \
        <= pos[:, None, None]
    scores = torch.where(seen, scores, float("-inf"))
    if src_mask is not None:
        scores = scores + src_mask.reshape(b, 1, -1).to(scores.dtype)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhl,bhld->bhd", att, vals).reshape(b, nh * dh)
    return out, torch.stack([keys, vals])


@boundary
def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size,
                     name=None):
    """(the largest encoder length, the largest decoder length)."""
    return seq_lens_encoder.max(), seq_lens_decoder.max()


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets, cum_offsets, cu_seqlens_q,
                              cu_seqlens_k, block_tables, *args, **kwargs):
    """The paged-attention decode step over block tables: every sequence
    brings one token (seq_lens_this_time == 1; prefill raises). qkv
    [B, 3*H*D], key_cache / value_cache [max_blocks, H, block_size, D],
    block_tables [B, max_blocks_per_seq], seq_lens_decoder [B] the
    tokens already cached. Returns (out [B, H*D], key_cache,
    value_cache) with the new token written at seq_lens_decoder[b]."""
    stt = seq_lens_this_time
    if isinstance(stt, torch.Tensor):
        stt = stt.cpu()
    stt = np.asarray(stt.numpy() if hasattr(stt, "numpy") else stt)
    if not (stt == 1).all():
        raise NotImplementedError(
            "block_multihead_attention: only the decode step "
            "(seq_lens_this_time == 1) is supported; run prefill through "
            "the generation engine's flash path")
    return _block_mha(qkv, key_cache, value_cache, seq_lens_decoder,
                      block_tables)


@op("block_multihead_attention")
def _block_mha(x, kc, vc, lens, tables):
    b = x.shape[0]
    nh, bs, dh = kc.shape[1], kc.shape[2], kc.shape[3]
    width = tables.shape[1] * bs
    q, k, v = x.reshape(b, 3, nh, dh).unbind(1)                # [B, H, D]
    pos = lens.long()
    blk = tables.long().gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    kc, vc = kc.clone(), vc.clone()
    kc[blk, :, off] = k.to(kc.dtype)
    vc[blk, :, off] = v.to(vc.dtype)
    tb = tables.long().clamp(0, kc.shape[0] - 1)

    def gather(c):                      # [B, H, width, D]
        return c[tb].transpose(1, 2).reshape(b, nh, width, dh)

    keys, vals = gather(kc), gather(vc)
    scores = torch.einsum("bhd,bhtd->bht", q, keys) / torch.sqrt(
        torch.tensor(float(dh))).to(q.dtype)
    valid = torch.arange(width, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, :], scores,
                         torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bht,bhtd->bhd", att, vals).reshape(b, nh * dh)
    return out, kc, vc


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0,
                                               name=None):
    """Attention over [B, H, S, D] with each sequence's valid key length
    (`kv_seq_lens`) as a dense mask; rows with no key are 0."""
    return _varlen_mea(query, key, value, seq_lens, kv_seq_lens, mask,
                       scale, causal)


@op("varlen_mem_efficient_attention")
def _varlen_mea(q, k, v, seq_lens, kv_lens, mask, scale, causal):
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sc
    if mask is not None:
        scores = scores + mask
    kmask = torch.arange(k.shape[2], device=q.device)[None, None, None, :] \
        < kv_lens[:, None, None, None]
    scores = torch.where(kmask, scores, float("-inf"))
    if causal:
        cm = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                        device=q.device).tril()
        scores = torch.where(cm[None, None], scores, float("-inf"))
    att = torch.softmax(scores, dim=-1)
    att = torch.where(torch.isnan(att), 0.0, att)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


@boundary
def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, time_step=None,
                            attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False,
                            mode='upscale_in_train', trans_qkvw=True,
                            ring_id=-1, name=None):
    """N transformer layers as the reference's serving megakernel stacks
    them, as a layer loop (the cached decode, `cache_kvs` / `time_step`,
    raises: drive `masked_multihead_attention` per layer)."""
    if cache_kvs is not None or time_step is not None:
        raise NotImplementedError(
            "fused_multi_transformer cached decoding (cache_kvs/time_step) "
            "is not emulated here — drive per-layer "
            "masked_multihead_attention for the KV-cache decode loop")
    out = x
    for i in range(len(qkv_weights)):
        residual = out
        h = F.layer_norm(out, out.shape[-1:], weight=ln_scales[i],
                         bias=ln_biases[i], epsilon=epsilon) \
            if pre_layer_norm else out
        b, s, hidden = h.shape
        wq = qkv_weights[i]
        qkv = F.linear(h, wq.reshape(-1, hidden).T if trans_qkvw
                       else wq.reshape(hidden, -1),
                       qkv_biases[i].reshape(-1)
                       if qkv_biases is not None and qkv_biases[i] is not None
                       else None).reshape(b, s, 3, -1)
        d_model = qkv.shape[-1]
        wshape = list(wq.shape)
        if len(wshape) == 4:
            heads, dh = (wshape[1], wshape[2]) if trans_qkvw \
                else (wshape[2], wshape[3])
            if heads * dh != d_model:
                raise ValueError(
                    f"qkv weight shape {wshape} inconsistent with qkv "
                    f"projection width {d_model}")
        elif d_model % 64 == 0:
            # 2-D weights carry no head split; the common default
            dh = 64
            heads = d_model // dh
        else:
            raise ValueError(
                "fused_multi_transformer cannot derive the head split from "
                f"2-D qkv weights of shape {wshape} (width {d_model} not a "
                "multiple of 64); pass 4-D weights ([3, num_head, dim_head, "
                "dim_embed] when trans_qkvw else [dim_embed, 3, num_head, "
                "dim_head])")
        q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.unbind(2))
        att = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=dropout_rate,
            is_causal=attn_mask is None, training=training)
        out = residual + F.linear(
            att.reshape(b, s, d_model), linear_weights[i],
            linear_biases[i] if linear_biases is not None else None)
        if not pre_layer_norm:
            out = F.layer_norm(out, out.shape[-1:], weight=ln_scales[i],
                               bias=ln_biases[i], epsilon=epsilon)
        residual = out
        h = F.layer_norm(out, out.shape[-1:], weight=ffn_ln_scales[i],
                         bias=ffn_ln_biases[i], epsilon=epsilon) \
            if pre_layer_norm else out
        h = getattr(F, activation)(F.linear(
            h, ffn1_weights[i],
            ffn1_biases[i] if ffn1_biases is not None else None))
        out = residual + F.linear(
            h, ffn2_weights[i],
            ffn2_biases[i] if ffn2_biases is not None else None)
        if not pre_layer_norm:
            out = F.layer_norm(out, out.shape[-1:], weight=ffn_ln_scales[i],
                               bias=ffn_ln_biases[i], epsilon=epsilon)
    return out, cache_kvs


# ------------------------------------------------------------ quantization
@op("weight_quantize", n_diff=0)
def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1,
                    name=None):
    """(quantized weight, f32 scales) of a [K, N] weight with per-out-
    channel absmax scales. weight_only_int4 stores packed int4, two
    nibbles per byte, [ceil(K/2), N] int8 (`ops.quantized`'s split-half
    layout), with group-wise scales [K // group_size, N] when `group_size`
    > 0. A group size that does not divide K, or one with int8, raises
    ValueError, as the reference's does. The scales are the reference
    op's to the bit (`ops.quantized._over`)."""
    if algo not in ("weight_only_int8", "weight_only_int4", "llm.int8"):
        raise ValueError(f"weight_quantize: unknown algo {algo!r}")
    if algo == "weight_only_int4":
        k = int(x.shape[-2]) if x.dim() >= 2 else int(x.shape[0])
        if group_size and group_size > 0 and k % group_size:
            raise ValueError(
                f"weight_quantize: group_size {group_size} does not divide "
                f"K={k} — int4 packing refuses to quietly widen")
        return quantize_int4(x, group_size, reciprocal=True)
    if group_size and group_size > 0:
        raise ValueError(
            f"weight_quantize: group_size is an int4 packing knob; "
            f"{algo} stores per-out-channel scales only")
    return quantize_int8(x, 127.0, reciprocal=True)


@boundary
def weight_quantize_raw(w, qmax=127.0):
    """Per-output-channel absmax int8 of a [K, N] weight: (q int8, scale
    f32 [N]), codes clipped to +-qmax. The one rule that
    `weight_quantize` and the serving path's weight-only int8 share
    (`ops.quantized.quantize_int8`)."""
    return quantize_int8(w, float(qmax))


@op("weight_dequantize", n_diff=0)
def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float16",
                      k=None, name=None):
    """Quantized weight + scales -> the float weight in `out_dtype`. For
    weight_only_int4 `x` is the packed [ceil(K/2), N] storage; `k` gives
    an odd logical K (default 2 * packed rows)."""
    dt = convert_dtype(out_dtype)
    if algo == "weight_only_int4":
        kk = int(k) if k is not None else 2 * int(x.shape[-2])
        return dequant_int4(x, scale, kk, dt)
    return (x.float() * scale[None, :]).to(dt)


@op("weight_only_linear")
def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1,
                       name=None):
    """y = x @ dequant(weight) + bias over a weight-only pair:
    weight_dtype="int8" takes weight [K, N] int8 (the reference's plain
    arithmetic), "int4" the packed [ceil(K/2), N] storage of
    `weight_quantize(algo="weight_only_int4")`, per-channel [N] or grouped
    [G, N] scales. Through `ops.quantized.quant_matmul`: per-channel int4
    is K8 on a card. Only x takes a gradient (`ops.quantized.
    quant_linear`), as in the reference's tape."""
    if weight_scale is None:
        raise ValueError("weight_only_linear requires weight_scale")
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(
            f"weight_only_linear: unsupported weight_dtype {weight_dtype!r}"
            " (int8 | int4)")
    out = quant_linear(x, weight, weight_scale.detach())
    return out if bias is None else out + bias.detach()


@op("llm_int8_linear")
def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0,
                    name=None):
    """LLM.int8() (Dettmers 2022) mixed-precision GEMM: activation columns
    whose absmax exceeds `threshold` run in f32 against the dequantized
    weight rows, the rest as int8 x int8 -> int32
    (`ops.quantized.int8_matmul`: cuBLASLt's int8 GEMM on a card, exact
    sums). Only x takes a gradient, as in the reference's tape."""
    if weight_scale is None:
        raise ValueError("llm_int8_linear requires weight_scale")
    s = weight_scale.detach()
    af = x.float()
    k = af.shape[-1]
    col_max = af.reshape(-1, k).abs().amax(dim=0)
    outlier = col_max > threshold                          # [K]
    a_scale = torch.clamp_min(torch.where(
        outlier, 0.0, af).abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
    qa = torch.clamp(torch.round(af / a_scale), -127, 127).to(torch.int8)
    qa = torch.where(outlier, 0, qa).to(torch.int8)
    qw = torch.where(outlier[:, None], 0, weight).to(torch.int8)
    reg = int8_matmul(qa.reshape(-1, k), qw).float()
    reg = reg.reshape(*af.shape[:-1], -1) * a_scale * s[None, :]
    wf = weight.float() * s[None, :]
    out = reg + torch.where(outlier, af, 0.0) @ torch.where(
        outlier[:, None], wf, 0.0)
    if bias is not None:
        out = out + bias.detach().float()
    return out.to(x.dtype)


def memory_efficient_attention(query, key, value, bias=None, cu_seqlens_q=None,
                               cu_seqlens_k=None, max_seqlen_q=None,
                               max_seqlen_k=None, causal=False, dropout_p=0.0,
                               scale=None, training=True, name=None):
    """Port of paddle_tpu/incubate/nn/functional `memory_efficient_attention`
    (:659): query/key/value [B, S, H, D], or packed [total, H, D] with
    cu_seqlens. With cu_seqlens_q it is `flash_attn_unpadded` (K1v/K2v for
    self-attention without dropout); without, `scaled_dot_product_attention`
    with `bias` as its mask and q scaled by scale * sqrt(D) when `scale` is
    given."""
    if cu_seqlens_q is not None:
        out, _ = F.flash_attn_unpadded(
            query, key, value, cu_seqlens_q, cu_seqlens_k,
            max_seqlen_q, max_seqlen_k, scale=scale, dropout=dropout_p,
            causal=causal, training=training)
        return out
    q = query
    if scale is not None:
        q = query * (scale * math.sqrt(int(query.shape[-1])))
    return F.scaled_dot_product_attention(
        q, key, value, attn_mask=bias, dropout_p=dropout_p,
        is_causal=causal, training=training)
