"""Continuous-batching serving engine over the paged KV cache.

Port of paddle_tpu/inference/engine.py: a fixed SLOT array, block-granular
KV allocation with admission control, and requests that join freed slots
mid-flight instead of waiting for a whole static batch to drain.

Same contract as the reference, different mechanism. Per scheduler tick
the engine admits joining requests, runs ONE CHUNK for each slot whose
prompt is still prefilling, then ONE DECODE step advancing every slot
whose prefill is done one token (the slot state compacted to a
slot-count bucket; each layer appends its K/V through the block tables
and attends through the paged decode kernel). A cache-cold prompt of at
most `chunked_prefill_tokens` tokens prefills whole at admission (padded
to its length bucket; attention through the flash kernel, the prompt's
K/V scattered into its pages); a longer prompt, or one whose prefix the
prefix cache serves, is prefilled a chunk a tick by the chunk program
(Q/K/V at the chunk's positions, the chunk's K/V scattered token by
token, attention over the gathered context pages under a causal mask: an
XLA composition in the reference, plain torch here).

Programs: the reference compiles one XLA program per key and replays it;
the port keeps a per-engine table of the same keys (`_programs`, see
`inference.programs`): (site, bucket, any_sample, extra), with the sites
"serving.decode" and "serving.prefill" (extra ()) and
"serving.chunk_prefill" (extra (ctx_pages, is_last)). On a card each
program is a CUDA graph of the whole step (embed, every layer, the KV
appends, logits and the token pick), captured at the key's first call and
replayed for every call; on the CPU the same table calls the step on the
same static buffers. Where the reference donates the pool and scans
stacked layer weights, the port updates the pool in place and loops over
layers in Python; the bucket sizes are the reference's, so the same
prompt, chunk, context and slot shapes reach the kernels.

Prefix caching: admission content-hashes the prompt's full KV blocks and
points the block table at cached blocks for the shared prefix; release
goes through the `PrefixCache` refcounts, and a shared block that a
whole-prompt hit must partly overwrite (its last token is recomputed) is
copied first (copy-on-write). The defaults are the reference's:
FLAGS_prefix_cache (on), FLAGS_chunked_prefill_tokens (256) and
FLAGS_prefix_cache_max_blocks (0).

Scheduling (admission, eos/length/deadline finish, block free/reuse,
drain, stats) is host-side Python, as in the reference.

Quantized serving: `kv_cache_dtype="int8"|"int4"` stores the pool as
int8 codes (int4: two tokens per byte) with one f32 scale per (layer,
block), requantized on every append, and decodes through the quantized
paged-decode kernels; `weight_quant="int8"|"int4"` stores the layer
matmuls and the lm_head as weight-only pairs (int4 through the
dequant-matmul kernel, int8 as the reference's plain arithmetic).

Speculative decoding (`spec_decode`, inference/speculative.py): each
tick the proposer offers candidates for the speculating slots, which ride
one verify window ("serving.spec_verify", extra (k,)): the window's K/V
scattered through the block tables, dense attention over the gathered
pages, f32 logits [B, k + 1, V] and the accept rule, in one program; the
other slots take the ordinary decode in the same tick. The host reads the
accepted flags and targets once per window and rolls back by bookkeeping
alone.

Models: LLaMA and GPT (the model's `_gen_arch`), through the one block
of `text.generation` (`_attend_block` + `_mlp_block`): GPT's LayerNorms,
fused qkv, learned positions (gathered at clamped positions, as JAX's
gather clamps) and GELU ride the same programs, kernels and buckets.

Telemetry (obs): each engine owns a metrics `Registry` with every
`serving_*` family of the reference's; `stats()` is a thin view over it,
`metrics()` its snapshot, `render_prometheus()` its exposition, and with
FLAGS_obs_http_port > 0 it registers on the process's shared
`/metrics` / `/healthz` endpoint (`close()` detaches it). A flight
recorder keeps every request's span timeline (queue wait, the prefill
program or each chunk, decode ticks, verify windows) for `dump_trace`;
a timeout, a TTFT SLO breach or a capture after `finish_warmup()` is an
anomaly, counted and, with FLAGS_obs_flight_dir, dumped. A program key's
first call is the obs watchdog's compile event (on a card: the CUDA-graph
capture and its wall).

Sampling runs inside the programs (a greedy key is a bare argmax, a
sampling key `_sample_batched`) from a `torch.Generator` on the engine's
device seeded from `seed`, which a sampling graph registers: sampled
tokens cannot reproduce JAX's random bits, greedy rows stay an exact
argmax.
"""
from __future__ import annotations

import functools
import hashlib
import itertools
import time
from collections import OrderedDict, deque

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..core.flags import flag
from ..core.graphs import side_stream as _side_stream
from ..jit.api import default_buckets
from ..obs import costs as _costs
from ..ops._cuda_common import ceil_to as _ceil_to
from ..ops._cuda_common import resolve_device
from ..ops.flash_attention import flash_attention_fwd
from ..ops.paged_decode import paged_decode_attention
from ..ops.quantized import quant_matmul_raw
from ..text.generation import (_SAMP_KEYS, _cached_block,  # noqa: F401
                               _dense_attention, _embed, _extract,
                               _filter_logits, _layer_forward_prefill,
                               _logits, _rope_at, _rope_full,
                               _sample_batched, _spec_for, _tensors)
from ..text.generation import _categorical
from ..text.paged_cache import (TRASH_BLOCK, BlockAllocator, PagedKVCache,
                                PrefixCache, append_token,
                                append_token_int4, append_token_int8,
                                blocks_for, gather_context, hash_blocks,
                                scatter_chunk, scatter_chunk_int4,
                                scatter_chunk_int8, scatter_prefill,
                                scatter_prefill_int4, scatter_prefill_int8)
from .programs import Program


#: quantized KV-cache modes and their (append, scatter_prefill,
#: scatter_chunk) triples — the step functions dispatch on the kv_mode
#: string ("model" | "int8" | "int4") and carry the per-block scales only
#: when quantized
_KV_FNS = {
    "int8": (append_token_int8, scatter_prefill_int8, scatter_chunk_int8),
    "int4": (append_token_int4, scatter_prefill_int4, scatter_chunk_int4),
}


#: monotonically increasing engine names for the shared /metrics
#: endpoint's `engine` label (next() on the counter is atomic)
_ENGINE_IDS = itertools.count()


def _end_mark(device):
    """A mark of the work enqueued on `device` so far, dated later by
    `_ended_at` without waiting now: a timing event recorded on the
    current stream on a card (the engine's graphs replay on a side stream
    the caller's stream waits for), the host clock on the CPU, where the
    step ran eagerly and has ended."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _ended_at(marks, device):
    """The host-clock times (`time.perf_counter`) at which the work before
    each of `marks` (`_end_mark`) ended on the device. On a card one
    event recorded now and waited for dates the others by their elapsed
    time to it; after a read-back the stream is idle, so that wait is the
    event's own latency, not the programs'."""
    if device.type != "cuda":
        return list(marks)
    now = torch.cuda.Event(enable_timing=True)
    now.record(torch.cuda.current_stream(device))
    now.synchronize()
    t = time.perf_counter()
    return [t - m.elapsed_time(now) / 1e3 for m in marks]


def _next_tokens(logits, sample):
    """The step's output: the f32 logits [B, V] themselves when `sample`
    is None (a check's teacher-forced replay), else the next tokens [B]
    of `sample` = (any_sample, inputs, generator): a bare argmax for a
    greedy key, `_sample_batched` over the rows' parameters (`inputs`
    holds the `_SAMP_KEYS`) for a sampling key."""
    if sample is None:
        return logits
    any_sample, inputs, generator = sample
    if not any_sample:
        return logits.argmax(dim=-1)
    return _sample_batched(logits, generator,
                           *(inputs[k] for k in _SAMP_KEYS))


def _index(i, device):
    """A position as a 1-element index tensor: an int, or a 0-dim tensor
    (a program's static input), which is viewed, never read back."""
    return torch.as_tensor(i, device=device).reshape(1)


# --------------------------------------------------- paged decode layers

def _paged_attn(q, k_new, v_new, kc, vc, ksc, vsc, tables, pos,
                block_size, kv_mode, decode_attention=paged_decode_attention):
    """Append this step's K/V through the block tables (in place; the
    quantized modes requantize the touched blocks and update their scales
    ksc/vsc), then paged decode attention over lens = pos + 1 (the
    just-written token included). kc/vc are one layer's pool slice, ksc/
    vsc its scales [N] (None in the model mode)."""
    b = q.shape[0]
    blk = tables[torch.arange(b, device=q.device), pos // block_size]
    off = pos % block_size
    if kv_mode != "model":
        app = _KV_FNS[kv_mode][0]
        app(kc, ksc, k_new, blk, off)
        app(vc, vsc, v_new, blk, off)
    else:
        append_token(kc, k_new, blk, off)
        append_token(vc, v_new, blk, off)
    lens = (pos + 1).to(torch.int32)
    return decode_attention(q.contiguous(), kc, vc, tables, lens, ksc, vsc,
                            kv_int4=kv_mode == "int4")


# ------------------------------------------------------- step functions
# The kernel functions are arguments, defaulting to the routed wrappers
# (which take their plain versions for CPU tensors), so a check can run
# the same steps through the plain versions on the card.

@torch.no_grad()
def _decode_step(spec, block_size, kv_mode, params, cache, tok, pos, tables,
                 sample=None, decode_attention=paged_decode_attention,
                 qmm=quant_matmul_raw):
    """One decode step for a compacted slot bucket: every row consumes its
    token, appends K/V through its block table and attends over its own
    length. Returns the next tokens [B] picked by `sample` (see
    `_next_tokens`), or the f32 logits [B, V] when it is None."""
    quantized = kv_mode != "model"
    x = _embed(params, spec, tok, pos)                      # [B, H]
    cos, sin = _rope_at(params, spec, pos)                  # [B, 1, D]

    def attend(li, q, k, v):
        return _paged_attn(q, k, v, cache.k[li], cache.v[li],
                           cache.k_scale[li] if quantized else None,
                           cache.v_scale[li] if quantized else None,
                           tables, pos, block_size, kv_mode,
                           decode_attention)

    for li, lw in enumerate(params["layers"]):
        x = _cached_block(x, lw, spec, cos, sin,
                          functools.partial(attend, li), qmm)
    return _next_tokens(_logits(x, params, spec, qmm), sample)


@torch.no_grad()
def _prefill_step(spec, block_size, kv_mode, params, cache, ids, true_len,
                  table_row, sample=None, attention=flash_attention_fwd,
                  qmm=quant_matmul_raw):
    """Prefill one joining request: full-prompt forward (flash kernel),
    page-scatter the prompt K/V through the slot's block table (the
    quantized modes with one new scale per page), and return the first
    token [1] picked by `sample` (see `_next_tokens`; the f32 logits [1,
    V] when it is None) from the last REAL prompt position. `true_len` is
    an int or a 0-dim tensor, never read back."""
    x = _embed(params, spec, ids)                           # [1, S, H]
    cos, sin = _rope_full(params, spec)
    ks, vs = [], []
    for lw in params["layers"]:
        x, (k, v) = _layer_forward_prefill(x, lw, spec, cos, sin,
                                           attention=attention, qmm=qmm)
        ks.append(k[0])
        vs.append(v[0])
    ks, vs = torch.stack(ks), torch.stack(vs)            # [L, S, Hkv, D]
    if kv_mode != "model":
        scat = _KV_FNS[kv_mode][1]
        scat(cache.k, cache.k_scale, ks, true_len, table_row, block_size)
        scat(cache.v, cache.v_scale, vs, true_len, table_row, block_size)
    else:
        scatter_prefill(cache.k, ks, true_len, table_row, block_size)
        scatter_prefill(cache.v, vs, true_len, table_row, block_size)
    last = x.index_select(1, _index(true_len, ids.device) - 1)[:, 0]
    return _next_tokens(_logits(last, params, spec, qmm), sample)


@torch.no_grad()
def _chunk_prefill_step(spec, block_size, kv_mode, emit_token, ctx_pages,
                        params, cache, ids, start, true_end, last_idx,
                        table_row, cow_src=TRASH_BLOCK, cow_dst=TRASH_BLOCK,
                        sample=None, qmm=quant_matmul_raw):
    """Prefill ONE chunk of one prompt: Q/K/V for positions [start,
    start + C) (ids [1, C], the chunk padded to its bucket; positions >=
    true_end are padding), the chunk's K/V scattered through the block
    table token by token (a prefix-cache suffix may start mid-block), and
    each chunk position attending over the whole context so far (cached
    prefix pages, earlier chunks, this chunk) gathered from the first
    `ctx_pages` table entries under a `kv_pos <= q_pos` mask, f32
    softmax. Copy-on-write first: block `cow_dst` takes `cow_src`'s
    contents in every layer, unconditionally, as the reference's program
    does (no copy to make: trash onto trash). The pool is updated in
    place. `start`, `true_end`, `last_idx`, `cow_src` and `cow_dst` are
    ints or 0-dim tensors, never read back. Returns the first token [1]
    picked by `sample` (see `_next_tokens`; the f32 logits [1, V] when it
    is None) at the chunk-local index `last_idx` when `emit_token` (the
    prompt's final chunk), else None: earlier chunks skip the vocab
    matmul."""
    quantized = kv_mode != "model"
    dev = ids.device
    src, dst = _index(cow_src, dev), _index(cow_dst, dev)
    for t in (cache.k, cache.v) + ((cache.k_scale, cache.v_scale)
                                   if quantized else ()):
        t.index_copy_(1, dst, t.index_select(1, src))
    c = ids.shape[1]
    pos = start + torch.arange(c, device=dev)
    # padded positions may run past the position tables: `_embed` and
    # `_rope_at` clamp, as JAX's gather does (their outputs are never
    # read)
    x = _embed(params, spec, ids[0], pos)                   # [C, H]
    cos, sin = _rope_at(params, spec, pos)                  # [C, 1, D]
    kv_pos = torch.arange(ctx_pages * block_size, device=dev)
    q_mask = kv_pos[None, :] <= pos[:, None]                # [C, T]
    int4 = kv_mode == "int4"

    def attend(li, q, k, v):
        kc, vc = cache.k[li], cache.v[li]
        ksc = cache.k_scale[li] if quantized else None
        vsc = cache.v_scale[li] if quantized else None
        if quantized:
            scat = _KV_FNS[kv_mode][2]
            scat(kc, ksc, k, start, true_end, table_row, block_size)
            scat(vc, vsc, v, start, true_end, table_row, block_size)
        else:
            scatter_chunk(kc, k, start, true_end, table_row, block_size)
            scatter_chunk(vc, v, start, true_end, table_row, block_size)
        kx = gather_context(kc, ksc, table_row, ctx_pages, int4=int4)
        vx = gather_context(vc, vsc, table_row, ctx_pages, int4=int4)
        return _dense_attention(q[None], kx[None], vx[None],
                                q_mask[None])[0]

    for li, lw in enumerate(params["layers"]):
        x = _cached_block(x, lw, spec, cos, sin,
                          functools.partial(attend, li), qmm)
    if not emit_token:
        return None
    last = x.index_select(0, _index(last_idx, dev))
    return _next_tokens(_logits(last, params, spec, qmm), sample)


def _verify_tokens(lg, proposed, sample=None):
    """The accept/emit rule over the verify window's [B, C, V] logits (C
    = K + 1 candidate positions; `proposed` [B, K] = candidates 1..K).
    Greedy rows accept while each proposal matches the verifier's own
    argmax. Sampling rows (`sample` = (any_sample, inputs, generator) as
    `_next_tokens` takes it) run Leviathan-style rejection sampling
    against the row's filtered distribution p (the draft proposes a point
    mass): accept x with probability p(x); a rejection resamples from p
    with x removed; position K draws the all-accepted bonus token.
    Returns (acc [B, K] bool, tgt [B, C]): tgt[:, j] is the token to emit
    when acceptance stops at position j."""
    b, c, v = lg.shape
    kk = c - 1
    greedy = lg.argmax(dim=-1)                                 # [B, C]
    acc = proposed == greedy[:, :kk]
    if sample is None or not sample[0]:
        return acc, greedy
    _, samp, gen = sample
    filt = _filter_logits(
        lg.reshape(b * c, v), samp["temperature"].repeat_interleave(c),
        samp["top_k"].repeat_interleave(c),
        samp["top_p"].repeat_interleave(c)).reshape(b, c, v)
    probs = torch.softmax(filt, dim=-1)
    u = torch.rand((b, kk), generator=gen, device=lg.device)
    p_prop = probs[:, :kk].gather(-1, proposed[..., None])[..., 0]
    acc_s = u < p_prop    # p(x) = 1 always accepts: the residual is empty
    res = filt[:, :kk].masked_fill(
        F.one_hot(proposed, v).bool(), float("-inf"))
    resample = _categorical(res, gen)
    bonus = _categorical(filt[:, kk], gen)
    tgt_s = torch.cat([resample, bonus[:, None]], dim=1)
    ds = samp["do_sample"][:, None]
    return torch.where(ds, acc_s, acc), torch.where(ds, tgt_s, greedy)


@torch.no_grad()
def _spec_verify_step(spec, block_size, kv_mode, params, cache, toks, pos,
                      tables, limit, sample=None, qmm=quant_matmul_raw):
    """Score C = K + 1 candidate positions per slot in one pass, the
    verify half of speculative decoding: one weight sweep, as a decode
    tick. toks[:, 0] is each slot's last emitted (not yet consumed)
    token, toks[:, 1:] its K proposals; row b writes candidate K/V at
    positions pos[b] + [0, C) through its block table (`scatter_chunk` and
    its int8 / int4 forms, positions >= limit[b], the slot's allocated
    watermark, to the trash block), and each candidate attends over the
    row's gathered context pages under `kv_pos <= q_pos` (dense, f32
    softmax, as the chunk program). The per-row scatter is a Python loop
    over the bucket's rows, unrolled in a captured graph. Returns
    `_verify_tokens`'s (acc [B, K], tgt [B, C])."""
    quantized = kv_mode != "model"
    b, c = toks.shape
    dev = toks.device
    qpos = pos[:, None] + torch.arange(c, device=dev)[None, :]   # [B, C]
    x = _embed(params, spec, toks, qpos)                         # [B, C, H]
    cos, sin = _rope_at(params, spec, qpos)                      # [B, C, 1, D]
    pages = tables.shape[1]
    end = torch.minimum(pos + c, limit)
    kv_pos = torch.arange(pages * block_size, device=dev)
    q_mask = kv_pos[None, None, :] <= qpos[:, :, None]          # [B, C, T]
    int4 = kv_mode == "int4"

    def attend(li, q, k, v):
        kc, vc = cache.k[li], cache.v[li]
        ksc = cache.k_scale[li] if quantized else None
        vsc = cache.v_scale[li] if quantized else None
        for bi in range(b):
            if quantized:
                scat = _KV_FNS[kv_mode][2]
                scat(kc, ksc, k[bi], pos[bi], end[bi], tables[bi],
                     block_size)
                scat(vc, vsc, v[bi], pos[bi], end[bi], tables[bi],
                     block_size)
            else:
                scatter_chunk(kc, k[bi], pos[bi], end[bi], tables[bi],
                              block_size)
                scatter_chunk(vc, v[bi], pos[bi], end[bi], tables[bi],
                              block_size)
        kx = torch.stack([gather_context(kc, ksc, tables[bi], pages,
                                         int4=int4) for bi in range(b)])
        vx = torch.stack([gather_context(vc, vsc, tables[bi], pages,
                                         int4=int4) for bi in range(b)])
        return _dense_attention(q, kx, vx, q_mask)

    for li, lw in enumerate(params["layers"]):
        x = _cached_block(x, lw, spec, cos, sin,
                          functools.partial(attend, li), qmm)
    lg = _logits(x.reshape(b * c, -1), params, spec, qmm).reshape(b, c, -1)
    return _verify_tokens(lg, toks[:, 1:], sample)


# ------------------------------------------------------------ scheduler

class Request:
    """One generation request riding the engine."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "do_sample",
                 "temperature", "top_k", "top_p", "eos_token_id",
                 "tokens", "arrival_s", "admitted_s", "first_token_s",
                 "finished", "max_time_ms", "deadline_s", "finish_reason",
                 "cached_len", "prefill_pos", "prefill_done", "_hashes",
                 "_hash_ns", "speculative", "_flight")

    def __init__(self, rid, prompt, max_new_tokens, do_sample, temperature,
                 top_k, top_p, eos_token_id, max_time_ms=None,
                 speculative=None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = -1 if eos_token_id is None else int(eos_token_id)
        self.tokens: list[int] = []
        self.arrival_s = time.perf_counter()
        self.admitted_s = None
        self.first_token_s = None
        self.finished = False
        # wall-clock budget from ARRIVAL; an expired request finishes with
        # reason "timeout" and releases its blocks
        self.max_time_ms = None if max_time_ms is None else float(max_time_ms)
        self.deadline_s = None if max_time_ms is None \
            else self.arrival_s + float(max_time_ms) / 1e3
        self.finish_reason = None   # "eos" | "length" | "timeout"
        # prefix-cache / chunked-prefill progress (set at admission):
        # positions [0, cached_len) come from cached blocks, the rest is
        # computed chunk by chunk; prefill_pos is the next position
        self.cached_len = 0
        self.prefill_pos = 0
        self.prefill_done = False
        # memoised prefix-block hashes: a pool-blocked head-of-line
        # request is re-examined every tick, and the sha256 chain over a
        # long prompt must not be recomputed each time
        self._hashes = None
        self._hash_ns = None
        # None follows the engine's config; False decodes normally even
        # on a speculating engine
        self.speculative = speculative
        # the flight recorder's timeline (obs/flight.py), set at
        # add_request
        self._flight = None

    def expired(self, now=None) -> bool:
        if self.deadline_s is None:
            return False
        return (time.perf_counter() if now is None else now) \
            >= self.deadline_s

    @property
    def ttft_s(self):
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def queue_wait_s(self):
        """Host wall spent waiting for admission (slot + block budget)."""
        if self.admitted_s is None:
            return None
        return self.admitted_s - self.arrival_s

    @property
    def prefill_s(self):
        """Admission -> first token. ttft_s == queue_wait_s + prefill_s."""
        if self.first_token_s is None or self.admitted_s is None:
            return None
        return self.first_token_s - self.admitted_s


class ServingEngine:
    """Continuous-batching scheduler over a fixed slot array + paged KV
    pool. `admission="continuous"` (default) refills freed slots
    mid-flight; `admission="static"` only admits into an EMPTY engine
    (whole-batch waves). Single-threaded: one owner thread drives
    `add_request`/`step`/`run`/`drain`; the read-only surfaces (`stats`,
    `metrics`, the /metrics endpoint, `close`) may be called from any
    thread.

    `kv_cache_dtype` ("model" | "int8" | "int4") defaults to
    FLAGS_kv_cache_dtype, `weight_quant` ("none" | "int8" | "int4") to
    FLAGS_weight_only_dtype, `prefix_cache` to FLAGS_prefix_cache,
    `chunked_prefill_tokens` to FLAGS_chunked_prefill_tokens and
    `prefix_cache_max_blocks` to FLAGS_prefix_cache_max_blocks and
    `spec_decode` ("off" | "ngram" | "draft" | a SpecConfig) to
    FLAGS_spec_decode. The model (a LLaMA or a GPT) must lie on `device`
    ("cuda" unless the caller asks for another; no card ->
    RuntimeError)."""

    def __init__(self, model, max_slots=None, kv_block_size=None,
                 num_kv_blocks=None, kv_cache_dtype=None,
                 max_model_len=None, seed=0, admission="continuous",
                 prefix_cache=None, chunked_prefill_tokens=None,
                 prefix_cache_max_blocks=None, spec_decode=None,
                 weight_quant=None, device=None):
        self.device = resolve_device(device)
        if weight_quant in (None, "none"):
            # serving-wide default; a per-engine weight_quant= overrides
            weight_quant = str(flag("FLAGS_weight_only_dtype"))
        if weight_quant not in ("none", "int8", "int4"):
            raise ValueError(f"weight_quant must be 'none', 'int8' or "
                             f"'int4', got {weight_quant!r}")
        self.weight_quant = str(weight_quant)
        mode = str(kv_cache_dtype or flag("FLAGS_kv_cache_dtype"))
        if mode not in ("model", "int8", "int4"):
            raise ValueError(f"kv_cache_dtype must be 'model', 'int8' or "
                             f"'int4', got {mode!r}")
        self.kv_mode = mode
        self.quantized = mode != "model"
        mdev = model.device
        if mdev.type != self.device.type or (
                self.device.index is not None
                and mdev.index != self.device.index):
            raise ValueError(f"model lies on {mdev}, engine device is "
                             f"{self.device}")
        cfg = model.config
        self.spec = _spec_for(model)
        self.params = _extract(model, self.spec, self.weight_quant)
        self.block_size = int(kv_block_size or flag("FLAGS_kv_block_size"))
        self.max_slots = int(max_slots or flag("FLAGS_serving_slots"))
        if self.max_slots < 1:
            raise ValueError("need at least one serving slot")
        # usable context rounds DOWN to whole pages
        max_pos = int(cfg.max_position_embeddings)
        mml = min(int(max_model_len or max_pos), max_pos)
        self.max_model_len = (mml // self.block_size) * self.block_size
        if self.max_model_len < self.block_size:
            raise ValueError(
                f"max_model_len {mml} below one kv block ({self.block_size})")
        self.pages = self.max_model_len // self.block_size
        # default pool: every slot can hold a full-context sequence (+ the
        # trash block); size it down to exercise admission control
        if num_kv_blocks is None:
            num_kv_blocks = 1 + self.max_slots * self.pages
        self.cache = PagedKVCache(
            self.spec.num_layers, int(num_kv_blocks),
            self.spec.num_kv_heads, self.block_size, self.spec.head_dim,
            mode if self.quantized else self.params["embed"].dtype,
            self.device)
        self.allocator = BlockAllocator(int(num_kv_blocks))
        if admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission mode {admission!r}")
        self.admission = admission
        # the PrefixCache wraps the allocator for EVERY alloc and release,
        # cache enabled or not: with it off nothing is ever registered, so
        # release is the free list
        self.prefix_cache_enabled = bool(
            flag("FLAGS_prefix_cache") if prefix_cache is None
            else prefix_cache)
        self.chunk_tokens = int(
            flag("FLAGS_chunked_prefill_tokens")
            if chunked_prefill_tokens is None else chunked_prefill_tokens)
        self.prefix_cache = PrefixCache(
            self.allocator, max_cached_blocks=int(
                flag("FLAGS_prefix_cache_max_blocks")
                if prefix_cache_max_blocks is None
                else prefix_cache_max_blocks))
        # seeds the hash chain: KV blocks are interchangeable only within
        # one (geometry, block size, cache mode, storage dtype, weight
        # quantization). Plain ints and strings, so the namespace is the
        # same in every process
        ns = (cfg.vocab_size, cfg.hidden_size, self.spec, self.block_size,
              self.kv_mode, str(self.cache.k.dtype), self.weight_quant)
        self._prefix_namespace = int.from_bytes(
            hashlib.sha256(repr(ns).encode()).digest()[:8], "little")
        self._slot_chunk: dict[int, dict] = {}    # slot -> chunk progress
        self._slot_extra_refs: list[list[int]] = [[] for _ in
                                                  range(self.max_slots)]
        # identical prompts re-admitted while the cache is on should hit;
        # LRU-capped so a long-lived engine's diagnostic stays bounded
        self._prompt_fingerprints: OrderedDict = OrderedDict()
        self._prompt_fingerprints_cap = 4096
        self.prefix_repeat_admissions = 0
        self._tables = np.zeros((self.max_slots, self.pages), np.int32)
        self._slot_req: list[Request | None] = [None] * self.max_slots
        self._slot_pos = np.zeros(self.max_slots, np.int64)
        self._slot_blocks: list[list[int]] = [[] for _ in
                                              range(self.max_slots)]
        self._waiting: deque[Request] = deque()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._next_id = 0
        self.steps = 0
        self.active_slot_steps = 0
        self.completed: dict[int, np.ndarray] = {}
        self.finish_reasons: dict[int, str] = {}
        self.ttfts: list[float] = []
        self.queue_waits: list[float] = []
        self._warmed = False
        self._draining = False
        # the program table: key -> Program. Per engine, unlike the
        # reference's module-level executables: a graph bakes in the
        # addresses of this engine's pool, parameters and buffers
        self._programs: dict = {}
        # the cost-ledger row of the program `_call` ran last
        self._last_entry = None
        # capture graphs (True exactly on a card); a check sets it False
        # on one engine, before its first call, to get the eager run it
        # compares with
        self._capture = self.device.type == "cuda"
        # what the program bodies read: they hold this tuple, never the
        # engine, so that no reference cycle keeps a dropped engine's
        # pool and graphs alive until the next garbage collection
        self._step_state = (self.spec, self.block_size, self.kv_mode,
                            self.params, self.cache, self._gen)
        self._stream = self._pool = None
        # captures and their wall seconds, [before, after] finish_warmup()
        self._captures = [0, 0]
        self._capture_s = [0.0, 0.0]
        self._init_metrics()
        from .speculative import SpecConfig, make_proposer

        if spec_decode is None:
            m = str(flag("FLAGS_spec_decode"))
            spec_decode = None if m == "off" else SpecConfig(method=m)
        elif isinstance(spec_decode, str):
            spec_decode = None if spec_decode == "off" \
                else SpecConfig(method=spec_decode)
        self.spec_config = spec_decode
        self.proposer = (make_proposer(spec_decode)
                         if spec_decode is not None else None)
        reg = self.registry
        reg.gauge("serving_slots", "engine slot count").set(self.max_slots)
        reg.gauge("serving_kv_pool_blocks",
                  "total KV blocks (incl. trash)").set(
                      self.allocator.num_blocks)
        self._m_pool_free.set(self.allocator.available)
        self.flight = obs.FlightRecorder()
        # chunks that emitted no token, their spans still open until the
        # next read-back (`_close_chunks`): (flight, trace-span record,
        # start, span args, cost-ledger row, `_end_mark`)
        self._open_chunks: list = []
        slo_ms = float(flag("FLAGS_obs_slo_ttft_ms"))
        self._slo_ttft_s = slo_ms / 1e3 if slo_ms > 0 else None
        self._log = obs.get_logger(__name__)
        self._metrics_server = None
        self._engine_name = None
        port = int(flag("FLAGS_obs_http_port"))
        if port > 0:
            # engines of one process share one endpoint per port: each
            # registers its registry (exported with an engine="..."
            # label) and a readiness probe (/healthz turns 200 once every
            # registered engine passed finish_warmup)
            try:
                self._engine_name = f"engine{next(_ENGINE_IDS)}"
                self._metrics_server = obs.shared_server(port)
                self._metrics_server.register_engine(
                    self._engine_name, reg, ready=lambda: self._warmed)
            except OSError as e:
                self._metrics_server = None
                self._log.warning(
                    f"obs metrics endpoint :{port} not started ({e}) — "
                    "this engine goes unscraped; use "
                    "obs.serve_metrics(port, engine.registry) to expose "
                    "it elsewhere", key="obs-http-bind")

    def _init_metrics(self):
        """The engine's registry with every `serving_*` family of the
        reference's engine, with its names, kinds, label names and help
        strings."""
        self.registry = reg = obs.Registry()
        self._m_ttft = reg.histogram(
            "serving_ttft_seconds", "arrival -> first token (= queue wait "
            "+ prefill)")
        self._m_queue_wait = reg.histogram(
            "serving_queue_wait_seconds",
            "arrival -> admission (slot + full block budget)")
        self._m_prefill = reg.histogram(
            "serving_prefill_seconds", "admission -> first token (the "
            "prefill program span, queue wait excluded)")
        self._m_decode_step = reg.histogram(
            "serving_decode_step_seconds", "one decode tick (all active "
            "slots advance one token)")
        self._m_tpot = reg.histogram(
            "serving_tpot_seconds", "time per output token, observed "
            "ONCE PER EMITTED TOKEN: tick wall / tokens the tick "
            "emitted (a speculative verify window divides by its "
            "accepted count — multi-token ticks report real TPOT, not "
            "a fake per-tick win)")
        self._m_decode_tokens = reg.counter(
            "serving_decode_tokens_total", "tokens emitted by decode ticks")
        self._m_prefill_tokens = reg.counter(
            "serving_prefill_tokens_total", "prompt tokens prefilled")
        self._m_completed = reg.counter(
            "serving_requests_completed_total", "requests finished (eos, "
            "length or timeout)")
        self._m_timeout = reg.counter(
            "serving_requests_timeout_total", "requests finished by their "
            "per-request deadline (max_time_ms) — slots/blocks reclaimed")
        self._m_rejects = reg.counter(
            "serving_admission_rejects_total", "requests rejected outright "
            "(could never be served)", ("reason",))
        self._m_drained = reg.counter(
            "serving_drained_requests_total", "requests that finished "
            "while the engine was draining (router drain/handoff — each "
            "one completed or timed out in place instead of being "
            "dropped by the deploy)")
        self._m_blocked = reg.counter(
            "serving_admission_blocked_total", "admission attempts that "
            "waited: head-of-line request's block budget did not fit the "
            "free pool")
        self._m_prefix_hit = reg.counter(
            "serving_prefix_blocks_hit_total", "prompt KV blocks served "
            "from the prefix cache (zero prefill paid for them)")
        self._m_prefix_miss = reg.counter(
            "serving_prefix_blocks_missed_total", "full prompt KV blocks "
            "that had to be computed (no cached prefix covered them)")
        self._m_chunks = reg.counter(
            "serving_prefill_chunks_total", "chunk-prefill program "
            "invocations (chunked + cache-hit-suffix prefills)")
        self._m_prefix_evict = reg.counter(
            "serving_prefix_cache_evictions_total", "cached blocks "
            "evicted (LRU, refcount-0 only) to satisfy allocations")
        self._m_cache_blocks = reg.gauge(
            "serving_prefix_cache_blocks", "blocks addressable by "
            "content hash (cached prefixes)")
        self._m_cache_refed = reg.gauge(
            "serving_prefix_cache_referenced_blocks", "hash-mapped blocks "
            "live requests still reference (refcount > 0)")
        self._m_queue_depth = reg.gauge(
            "serving_queue_depth", "requests waiting for admission")
        self._m_active = reg.gauge(
            "serving_active_slots", "slots currently decoding")
        self._m_pool_free = reg.gauge(
            "serving_block_pool_free_blocks", "free KV blocks")
        self._m_pool_used = reg.gauge(
            "serving_block_pool_used_blocks", "allocated KV blocks")
        self._m_flight_anomalies = reg.counter(
            "serving_flight_anomalies_total", "flight-recorder anomaly "
            "triggers observed (request timeout, TTFT SLO breach, "
            "post-warmup compile)", ("trigger",))
        self._m_flight_dumps = reg.counter(
            "serving_flight_dumps_total", "flight-recorder postmortem "
            "trace files written to FLAGS_obs_flight_dir", ("trigger",))
        self._m_flight_requests = reg.gauge(
            "serving_flight_requests", "request timelines held in the "
            "flight-recorder ring (active + finished)")
        # the speculative-decoding families exist whether or not the
        # engine speculates; a non-speculating engine never observes them
        self._m_spec_windows = reg.counter(
            "serving_spec_windows_total", "speculative verify windows "
            "executed (one K+1-candidate batched scoring pass per "
            "speculating slot per tick)")
        self._m_spec_proposed = reg.counter(
            "serving_spec_proposed_tokens_total", "draft tokens proposed "
            "into verify windows")
        self._m_spec_accepted = reg.counter(
            "serving_spec_accepted_tokens_total", "proposed tokens the "
            "verify oracle accepted (emitted without their own decode "
            "tick — the speculative goodput)")
        self._m_spec_accept_rate = reg.histogram(
            "serving_spec_accept_rate", "per-window acceptance fraction "
            "(accepted / proposed)")
        self._m_spec_emitted = reg.histogram(
            "serving_spec_accepted_per_window", "tokens emitted per "
            "verify window: accepted prefix + the correction/bonus "
            "token (1..K+1)")

    # ------------------------------------------------------------- API
    def add_request(self, prompt, max_new_tokens=32, do_sample=False,
                    temperature=1.0, top_k=0, top_p=1.0,
                    eos_token_id=None, max_time_ms=None,
                    speculative=None) -> int:
        """Queue a request. Raises ValueError when it could NEVER be served
        (context or pool too small) or the engine is draining, counted in
        serving_admission_rejects_total by reason; otherwise it waits for
        admission. `max_time_ms` is a wall-clock deadline from arrival:
        when it expires the request finishes with reason ``"timeout"``
        (the tokens produced so far are its result) and its blocks are
        released. `speculative=False` opts this request out of
        speculative decoding on a speculating engine (it decodes one token
        a tick beside the speculating slots); None follows the engine."""
        if self._draining:
            self._reject("draining",
                          "engine is draining: no new admissions until "
                          "teardown (route to another replica)")
        if torch.is_tensor(prompt):
            prompt = prompt.cpu().numpy()
        prompt = np.asarray(getattr(prompt, "_data", prompt),
                            np.int64).reshape(-1).astype(np.int32)
        if prompt.size < 1:
            self._reject("empty_prompt", "empty prompt")
        if int(max_new_tokens) < 1:
            self._reject("bad_max_new_tokens",
                         "max_new_tokens must be positive")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_model_len:
            self._reject(
                "context_overflow",
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds the engine context "
                f"({self.max_model_len} = max_position_embeddings rounded "
                f"down to whole {self.block_size}-token kv blocks)")
        need = blocks_for(total, self.block_size)
        if need > self.allocator.num_blocks - 1:
            self._reject(
                "pool_too_small",
                f"request needs {need} kv blocks but the pool only has "
                f"{self.allocator.num_blocks - 1}")
        if max_time_ms is not None and float(max_time_ms) <= 0:
            self._reject("bad_max_time_ms", "max_time_ms must be positive")
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, prompt, max_new_tokens, do_sample, temperature,
                      top_k, top_p, eos_token_id, max_time_ms=max_time_ms,
                      speculative=speculative)
        req._flight = self.flight.begin(rid, prompt.size,
                                        int(max_new_tokens), req.arrival_s)
        self._m_flight_requests.set(len(self.flight._flights))
        self._waiting.append(req)
        self._m_queue_depth.set(len(self._waiting))
        return rid

    def _reject(self, reason: str, msg: str):
        """An admission reject: count it by reason, log it (rate-limited)
        and raise ValueError."""
        self._m_rejects.labels(reason).inc()
        self._log.warning(f"admission reject ({reason}): {msg}",
                          key=f"reject:{reason}")
        raise ValueError(msg)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    def has_work(self) -> bool:
        return bool(self._waiting) or self.num_active > 0

    def step(self):
        """One scheduler tick: expire deadlined requests, admit joining
        requests (small cache-cold prompts prefill whole, long or
        cache-hit prompts enter the chunk ladder), advance every
        prefilling slot by one chunk, then every decoding slot by one
        token. Returns a list of (request_id, token, finished) for tokens
        emitted this tick; a request finished by its deadline emits a
        terminal ``(request_id, None, True)``."""
        emitted = self._expire()
        emitted.extend(self._admit())
        emitted.extend(self._chunk_phase())
        active = [i for i, r in enumerate(self._slot_req)
                  if r is not None and r.prefill_done]
        if active:
            # speculating slots ride the verify window, the rest (opt-outs,
            # empty proposals, a non-speculating engine) the ordinary
            # decode, both in the same tick
            spec_slots, props = self._spec_proposals(active)
            in_spec = set(spec_slots)
            plain = [i for i in active if i not in in_spec]
            if plain:
                emitted.extend(self._decode(plain))
            if spec_slots:
                emitted.extend(self._spec_decode(spec_slots, props))
            self.steps += 1
            self.active_slot_steps += len(active)
            self._m_active.set(len(active))
        if self._draining:
            done = sum(1 for _, _, fin in emitted if fin)
            if done:
                self._m_drained.inc(done)
        return emitted

    def run(self, max_steps=100000):
        """Drive the engine until every queued request completes; returns
        {request_id: np.ndarray of generated tokens}."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        else:
            raise RuntimeError("serving engine did not drain (max_steps)")
        self._close_chunks()
        return dict(self.completed)

    def stats(self) -> dict:
        """Scheduler counters and timings (host wall clock, seconds), the
        reference's keys: a thin view over the metrics registry (the same
        numbers /metrics exports) and the scheduler's own counters."""
        util = (self.active_slot_steps / (self.steps * self.max_slots)
                if self.steps else 0.0)
        proposed = int(self._m_spec_proposed.value)
        accepted = int(self._m_spec_accepted.value)
        return {"steps": self.steps,
                "decode_tokens": int(self._m_decode_tokens.value),
                "prefill_tokens": int(self._m_prefill_tokens.value),
                "decode_time_s": self._m_decode_step.sum,
                "prefill_time_s": self._m_prefill.sum,
                "queue_wait_time_s": self._m_queue_wait.sum,
                "slot_utilization": round(util, 4),
                "ttft_s": list(self.ttfts),
                "queue_wait_s": list(self.queue_waits),
                "admission_blocked": int(self._m_blocked.value),
                "requests_completed": int(self._m_completed.value),
                "draining": self._draining,
                "drained_requests": int(self._m_drained.value),
                "kv_pool_blocks": self.allocator.num_blocks,
                "kv_pool_free": self.allocator.available,
                "kv_hbm_bytes": self.cache.hbm_bytes,
                "kv_cache_mode": self.kv_mode,
                "weight_quant": self.weight_quant,
                "param_bytes": self.param_bytes,
                "prefix_blocks_hit": int(self._m_prefix_hit.value),
                "prefix_blocks_missed": int(self._m_prefix_miss.value),
                "prefix_cached_blocks": self.prefix_cache.cached_blocks,
                "prefix_evictions": self.prefix_cache.evictions,
                "prefill_chunks": int(self._m_chunks.value),
                "spec_windows": int(self._m_spec_windows.value),
                "spec_proposed_tokens": proposed,
                "spec_accepted_tokens": accepted,
                "spec_accept_rate": round(accepted / max(proposed, 1), 4)}

    def spec_stats(self) -> dict:
        """Speculative-decoding summary: acceptance over every verify
        window this engine ran."""
        proposed = int(self._m_spec_proposed.value)
        accepted = int(self._m_spec_accepted.value)
        return {"enabled": self.proposer is not None,
                "k": int(getattr(self.proposer, "k", 0) or 0),
                "windows": int(self._m_spec_windows.value),
                "proposed_tokens": proposed,
                "accepted_tokens": accepted,
                "accept_rate": accepted / proposed if proposed else 0.0}

    def metrics(self) -> dict:
        """The registry's snapshot (counters and gauges, histograms with
        their quantiles): the machine-readable serving telemetry."""
        return self.registry.to_dict()

    def render_prometheus(self) -> str:
        """The registry's Prometheus text exposition (a scrape body)."""
        return self.registry.render_prometheus()

    def dump_trace(self, path: str) -> str:
        """Write the flight-recorder ring to `path` as Chrome-trace /
        Perfetto JSON and return the path. Asserts first that every
        request's queue_wait + prefill spans sum bitwise to its recorded
        TTFT; obs.validate_trace(path) re-checks the file."""
        self._close_chunks()
        return self.flight.dump(path)

    def finish_warmup(self):
        """Declare the engine warm: every program its workload needs has
        been captured. A program key first seen after this is a
        steady-state capture: its compile event is tagged warm (a
        post-warmup-compile finding of obs.audit_recompiles), it counts in
        the captures after warmup, and it is a flight-recorder anomaly.
        /healthz reports the engine ready from here on."""
        self._warmed = True
        return self

    @property
    def warmed(self) -> bool:
        return self._warmed

    def drain(self, deadline_ms=None):
        """Stop admission for handoff: every add_request from now on raises
        ValueError; requests already queued or in flight run until they
        finish. With a `deadline_ms` budget each live request's deadline
        is clamped to now + budget (the `max_time_ms` path then finishes
        it with reason "timeout"). `drained` turns True once queue and
        slots are empty; completions while draining count into
        stats()["drained_requests"]. Idempotent: a second drain() only
        tightens the deadline."""
        self._draining = True
        if deadline_ms is not None and float(deadline_ms) > 0:
            deadline_s = time.perf_counter() + float(deadline_ms) / 1e3
            live = list(self._waiting) + [r for r in self._slot_req
                                          if r is not None]
            for req in live:
                if req.deadline_s is None or req.deadline_s > deadline_s:
                    req.deadline_s = deadline_s
                    req.max_time_ms = (deadline_s - req.arrival_s) * 1e3
        return self

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """True once a draining engine has no queued or active work."""
        return self._draining and not self.has_work()

    def close(self):
        """Detach from the shared /metrics endpoint (nothing to do
        otherwise). The endpoint stays up for the other engines on it;
        obs.shared_server(port).close() stops it. Idempotent, and safe
        from any thread: the swap to a local means a second close can at
        worst unregister twice."""
        srv, self._metrics_server = self._metrics_server, None
        if srv is not None:
            srv.unregister_engine(self._engine_name)

    @property
    def param_bytes(self) -> int:
        """Bytes of the serving params AS STORED: packed int4 counts its
        two-nibbles-per-byte bytes, int8 its bytes, scales included."""
        return sum(t.numel() * t.element_size()
                   for t in _tensors(self.params))

    # --------------------------------------------------------- programs
    def _call(self, site, bucket, any_sample, extra, values, body):
        """Run the program of key (site, bucket, any_sample, extra) on the
        host `values` ({input name: numpy array}), made at the key's first
        call from `body` (a function of the static inputs that may read
        only what the key fixes, and `_step_state`, not the engine) and,
        with `_capture`, captured then. The first call is the watchdog's
        compile event, with the capture wall (or, run eagerly, the first
        call's). Returns the program's token tensor (None for a chunk that
        emits no token)."""
        key = (site, int(bucket), bool(any_sample), tuple(extra))
        prog = self._programs.get(key)
        if prog is not None:
            # a program outlives a clear_ledger(): its row comes back
            self._last_entry = _costs.reregister(prog.entry)
            return prog.run(values)
        prog = Program(key, values, body, self.device)
        keystr = self._keystr(bucket, any_sample, extra)
        # a key another engine of the same model geometry counted already
        # is not counted again (the row is the program's)
        count = _costs.needs_count(site, self._row_key(keystr))
        t0 = time.perf_counter()
        wall = self._capture_program(prog, any_sample, count) \
            if self._capture else None
        self._programs[key] = prog
        out = prog.run(values, count=count and wall is None)
        self._record_compile(prog, site, bucket, keystr,
                             time.perf_counter() - t0 if wall is None
                             else wall)
        return out

    def _row_key(self, keystr: str) -> str:
        """The program's cost-ledger key: its key string and its model's
        geometry (the step's spec and the served params' shapes and
        dtypes), so that two models' programs of one bucket keep two
        rows."""
        geometry = (self.spec, [(tuple(t.shape), str(t.dtype))
                                for t in _tensors(self.params)])
        digest = hashlib.sha1(repr(geometry).encode()).hexdigest()[:8]
        return f"{keystr}/spec{digest}"

    def _keystr(self, bucket, any_sample, extra) -> str:
        """A program key's string, the reference's."""
        return (f"bucket{bucket}/sample{int(any_sample)}/"
                f"kv{self.kv_mode}/w{self.weight_quant}"
                + "".join(f"/{x}" for x in extra))

    def _record_compile(self, prog, site, bucket, keystr, wall_s):
        """The cost-ledger row and the watchdog's compile event of a new
        program key; after finish_warmup() also a warning and the
        post-warmup anomaly. The row is `_last_entry` until the next
        call, for the caller's `observe` of its wall."""
        group = self._prog_group(site)
        prog.entry = self._last_entry = _costs.record_program(
            site, group, self._row_key(keystr), cost=prog.cost,
            wall_s=wall_s, bucket=int(bucket))
        obs.record_compile(site, group, keystr, bucket=int(bucket),
                           wall_s=wall_s, donated=True, warm=self._warmed,
                           cost=prog.entry.cost_summary())
        if self._warmed:
            self._log.warning(
                f"post-warmup compile: {site} bucket {bucket} captured "
                "after finish_warmup() — steady-state ticks must not "
                "capture", key=f"warm-compile:{site}")
            self._anomaly("post_warmup_compile")

    def _prog_group(self, site: str) -> str:
        return (f"{site}/L{self.spec.num_layers}"
                f"h{self.spec.num_heads}d{self.spec.head_dim}")

    def _anomaly(self, trigger: str):
        """One flight-recorder anomaly: count it and, with
        FLAGS_obs_flight_dir set, write the postmortem trace."""
        self._m_flight_anomalies.labels(trigger).inc()
        self._close_chunks()
        path = self.flight.anomaly_dump(trigger)
        if path is not None:
            self._m_flight_dumps.labels(trigger).inc()
            self._log.warning(
                f"flight recorder postmortem ({trigger}) dumped to "
                f"{path}", key=f"flight-dump:{trigger}")

    def _capture_program(self, prog, any_sample, count=False):
        """Capture `prog` on the device's side stream (`_side_stream`)
        into the engine's graph pool (its dry run counted into the cost
        ledger with `count`) and return the capture's wall seconds. Every graph of the engine shares the pool, keeps its
        static output referenced and replays on that one stream, so
        replay order does not matter: the pool memory a graph frees by
        the end of its capture held only its own temporaries, which a
        later capture may reuse because no two replays overlap; what
        outlives a replay (the KV pool, the static inputs, the
        parameters) lies outside the pool, and the static outputs, the
        only pool memory that outlives one, are never handed out
        again."""
        if self._stream is None:
            self._stream = _side_stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        wall = prog.capture(self._stream, self._pool,
                            self._gen if any_sample else None, count)
        self._captures[self._warmed] += 1
        self._capture_s[self._warmed] += wall
        return wall

    def _graph_stats(self) -> dict:
        """The capture counters: graphs captured and their wall (dry run,
        capture and instantiation) by site and in all, and the captures
        after finish_warmup()."""
        by_site: dict = {}
        wall: dict = {}
        for (site, *_), prog in self._programs.items():
            if prog.graph is not None:
                by_site[site] = by_site.get(site, 0) + 1
                wall[site] = wall.get(site, 0.0) + prog.capture_s
        return {"graphs_captured": by_site, "capture_s_by_site": wall,
                "capture_s": sum(self._capture_s),
                "captures_after_warmup": self._captures[1]}

    # ------------------------------------------------------- scheduling
    def _expire(self):
        """Active slots past their deadline finish now with reason
        "timeout" (blocks released through the prefix cache, a chunked
        prefill's copy-on-write source included); queued requests whose
        deadline lapsed finish empty without taking a slot. Each is a
        timeout anomaly. Returns the terminal ``(rid, None, True)``
        events."""
        now = time.perf_counter()
        emitted = []
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.expired(now):
                req.finish_reason = "timeout"
                self._m_timeout.inc()
                self._log.warning(
                    f"request {req.rid} hit its {req.max_time_ms:.0f}ms "
                    f"deadline after {len(req.tokens)} token(s); slot "
                    "and blocks reclaimed", key="request-timeout")
                self._finish(slot)
                self._anomaly("timeout")
                emitted.append((req.rid, None, True))
        expired_waiting = [r for r in self._waiting if r.expired(now)]
        if expired_waiting:
            self._waiting = deque(r for r in self._waiting
                                  if not r.expired(now))
            self._m_queue_depth.set(len(self._waiting))
            for req in expired_waiting:
                req.finished = True
                req.finish_reason = "timeout"
                self.completed[req.rid] = np.asarray(req.tokens, np.int64)
                self.finish_reasons[req.rid] = "timeout"
                self._m_timeout.inc()
                self._m_completed.inc()
                self.flight.finish(req.rid, now, "timeout")
                self._anomaly("timeout")
                emitted.append((req.rid, None, True))
        return emitted

    def _admit(self):
        """Admission control: head-of-line requests enter freed slots only
        when the pool covers their block budget (prompt + max new tokens)
        NET OF cached prefix blocks (evictable refcount-0 cached blocks
        count as capacity), so admitted requests never run out of cache
        mid-flight. Small cache-cold prompts prefill whole right here;
        long or cache-hit prompts enter the chunk ladder and emit their
        first token from a later chunk phase. Static mode additionally
        waits for the whole engine to drain."""
        if self.admission == "static" and self.num_active:
            return
        for slot in range(self.max_slots):
            if not self._waiting or self._slot_req[slot] is not None:
                continue
            req = self._waiting[0]
            s = req.prompt.size
            hashes = self._prompt_hashes(req)
            hit = self.prefix_cache.lookup(hashes)
            hit_blocks = len(hit)
            # the LAST prompt position is never served from cache: its
            # hidden state seeds the first token, so a whole-prompt hit
            # recomputes it into a copy-on-write duplicate of the shared
            # last block
            cow_src = None
            cached_len = len(hit) * self.block_size
            if cached_len > s - 1:
                cow_src = hit.pop()
                cached_len = s - 1
            need = blocks_for(s + req.max_new_tokens,
                              self.block_size) - len(hit)
            ids = self.prefix_cache.allocate(need)
            if ids is None:
                # pool full: wait for releases, and undo the lookup so
                # blocked retries neither leak refs nor inflate the hits
                undo = hit + ([cow_src] if cow_src is not None else [])
                self.prefix_cache.cancel_lookup(undo, len(hashes))
                self._m_blocked.inc()
                fl = req._flight
                if fl.blocked_ticks == 0:
                    fl.add_mark("admission_blocked", time.perf_counter(),
                                {"need_blocks": int(need),
                                 "available":
                                     int(self.prefix_cache.available)})
                fl.blocked_ticks += 1
                self._log.vlog(
                    2, f"admission blocked: request {req.rid} needs "
                    f"{need} blocks, {self.prefix_cache.available} "
                    "available", key="admission-blocked")
                break
            self._waiting.popleft()
            req.admitted_s = time.perf_counter()
            req.cached_len = cached_len
            req.prefill_pos = cached_len
            fl = req._flight
            fl.admitted_s = req.admitted_s
            fl.cached_blocks = hit_blocks
            fl.cow = cow_src is not None
            fl.add_mark("admitted", req.admitted_s,
                        {"slot": slot, "cached_blocks": hit_blocks,
                         "cached_len": int(cached_len),
                         "need_blocks": int(need)})
            self.queue_waits.append(req.queue_wait_s)
            self._m_queue_wait.observe(req.queue_wait_s)
            self._m_queue_depth.set(len(self._waiting))
            self._m_prefix_hit.inc(hit_blocks)
            self._m_prefix_miss.inc(len(hashes) - hit_blocks)
            if hashes:
                self._note_repeat(req)
            self._slot_req[slot] = req
            blocks = hit + ids
            self._slot_blocks[slot] = blocks
            self._tables[slot] = TRASH_BLOCK
            self._tables[slot, :len(blocks)] = blocks
            self._update_pool_gauges()
            if cached_len == 0 and (self.chunk_tokens <= 0
                                    or s <= self.chunk_tokens):
                tok, done = self._prefill(slot, req)
                self._register_full_blocks(slot)
                yield (req.rid, tok, done)
                if done:
                    self._finish(slot)
                continue
            # chunk ladder, one chunk a tick from cached_len. The COW
            # source's ref is held until the first chunk has copied it;
            # ids[0] occupies page cached_len // block_size, the page the
            # shared block served
            state = {"cow": None}
            if cow_src is not None:
                state["cow"] = (cow_src, ids[0])
                self._slot_extra_refs[slot].append(cow_src)
            self._slot_chunk[slot] = state

    def _update_pool_gauges(self):
        """The pool and prefix-cache gauges, and new evictions into their
        counter (and onto the flight recorder's engine track)."""
        self._m_pool_free.set(self.allocator.available)
        self._m_pool_used.set(self.allocator.num_blocks - 1
                              - self.allocator.available)
        self._m_cache_blocks.set(self.prefix_cache.cached_blocks)
        self._m_cache_refed.set(self.prefix_cache.referenced_blocks)
        ev = self.prefix_cache.evictions - self._m_prefix_evict.value
        if ev > 0:
            self._m_prefix_evict.inc(ev)
            self.flight.tick_mark("prefix_evictions", time.perf_counter(),
                                  evicted=int(ev))

    def _prompt_hashes(self, req):
        """The prompt's full-block hashes (none with the cache off),
        memoised per request and keyed on the namespace, so a namespace
        change rehashes."""
        if not self.prefix_cache_enabled:
            return []
        if req._hashes is None or req._hash_ns != self._prefix_namespace:
            req._hashes = hash_blocks(req.prompt, self.block_size,
                                      self._prefix_namespace)
            req._hash_ns = self._prefix_namespace
        return req._hashes

    def _note_repeat(self, req):
        """Count an admission whose prompt was admitted before
        (`prefix_repeat_admissions`: with the cache healthy, such a prompt
        hits). The fingerprint is independent of the hash chain, so a
        broken chain or a namespace drift cannot hide from it."""
        fp = hash(tuple(int(t) for t in req.prompt))
        if fp in self._prompt_fingerprints:
            self.prefix_repeat_admissions += 1
            self._prompt_fingerprints.move_to_end(fp)
        self._prompt_fingerprints[fp] = True
        while len(self._prompt_fingerprints) > self._prompt_fingerprints_cap:
            self._prompt_fingerprints.popitem(last=False)

    def _register_full_blocks(self, slot):
        """Publish this slot's FULLY written blocks in the prefix cache
        under their content hashes. Written watermark: the whole prompt
        once prefill finished, plus the generated tokens whose K/V a
        decode step appended (the last sampled token was never consumed),
        else the chunk ladder's progress."""
        if not self.prefix_cache_enabled:
            return
        req = self._slot_req[slot]
        if req.prefill_done:
            content = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        else:
            content = req.prompt[:req.prefill_pos]
        hashes = hash_blocks(content, self.block_size,
                             self._prefix_namespace)
        self.prefix_cache.register(hashes,
                                   self._slot_blocks[slot][:len(hashes)])

    def _prefill(self, slot, req):
        """The monolithic fast path: the whole prompt, padded to its
        length bucket, through the program of `_prefill_step` (K1), keyed
        by (bucket, do_sample). Its span ends at the first token's
        read-back."""
        s = req.prompt.size
        bucket = min(_ceil_to(default_buckets(s), self.block_size),
                     self.max_model_len)
        bucket = max(bucket, _ceil_to(s, self.block_size))
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s] = req.prompt
        values = {"ids": ids, "true_len": np.asarray(s, np.int64),
                  "table_row": self._tables[slot]}
        any_sample = req.do_sample
        if any_sample:
            values.update(self._samp_values([req]))

        spec, bs, mode, params, cache, gen = self._step_state

        def body(a):
            return _prefill_step(spec, bs, mode, params, cache, a["ids"],
                                 a["true_len"], a["table_row"],
                                 (any_sample, a, gen))

        t_run = time.perf_counter()
        with obs.span("serving.prefill"):
            tok = self._call("serving.prefill", bucket, any_sample, (),
                             values, body).tolist()[0]
        t_end = time.perf_counter()
        self._last_entry.observe(t_end - t_run)
        self._close_chunks()
        self._m_prefill_tokens.inc(s)
        req.prefill_pos = s
        req._flight.add_span("prefill_program", t_run, t_end,
                             {"bucket": bucket, "tokens": int(s)})
        self._first_token(slot, req, tok, t_end)
        return tok, self._check_done(req, tok)

    def _first_token(self, slot, req, tok, t):
        """Bookkeeping of a request's first token, read back at `t`: its
        prefill is done and its slot decodes from the next tick; the TTFT
        and its two parts are observed, the flight records the first
        token, and a TTFT past FLAGS_obs_slo_ttft_ms is an anomaly."""
        req.prefill_done = True
        req.first_token_s = t
        self._m_prefill.observe(req.prefill_s)
        self._m_ttft.observe(req.ttft_s)
        self.ttfts.append(req.ttft_s)
        req.tokens.append(tok)
        self._slot_pos[slot] = req.prompt.size
        fl = req._flight
        fl.first_token_s = fl.last_token_s = t
        fl.ttft_s = req.ttft_s
        fl.tokens += 1
        if self._slo_ttft_s is not None and req.ttft_s > self._slo_ttft_s:
            fl.add_mark("slo_breach", t,
                        {"ttft_s": req.ttft_s, "slo_s": self._slo_ttft_s})
            self._anomaly("slo_breach")

    def _chunk_phase(self):
        """Advance every prefilling slot by ONE chunk. A slot whose final
        chunk completes emits its first token and joins the decode set
        (this tick's decode step), so a long prompt costs in-flight
        decodes one chunk per tick, never its whole prefill."""
        emitted = []
        for slot in sorted(self._slot_chunk):
            req = self._slot_req[slot]
            tok = self._run_chunk(slot, req, self._slot_chunk[slot])
            if tok is None:
                continue
            del self._slot_chunk[slot]
            self._first_token(slot, req, tok, time.perf_counter())
            self._register_full_blocks(slot)
            done = self._check_done(req, tok)
            emitted.append((req.rid, tok, done))
            if done:
                self._finish(slot)
        return emitted

    def _run_chunk(self, slot, req, state):
        """One chunk-program call for one slot. Returns the first token
        when this was the prompt's final chunk, else None. The chunk is
        padded to its length bucket (at least 8) and the context to a
        page-count bucket covering the chunk's last position and at least
        one page past the chunk bucket — the reference's static shapes,
        one program per (chunk bucket, context bucket). The chunk's span
        ends at its token's read-back; a chunk that emits none reads
        nothing back, and its span stays open until the next read-back
        dates its end on the device (`_close_chunks`), so that the host
        does not wait for it."""
        s = req.prompt.size
        start = req.prefill_pos
        n = s - start if self.chunk_tokens <= 0 \
            else min(s - start, self.chunk_tokens)
        is_last = start + n >= s
        c_bucket = max(8, default_buckets(n))
        ctx_need = blocks_for(start + n, self.block_size)
        ctx_pages = min(self.pages, max(default_buckets(ctx_need),
                                        blocks_for(c_bucket,
                                                   self.block_size) + 1))
        cow = state.pop("cow", None)
        cow_src, cow_dst = cow if cow is not None else (TRASH_BLOCK,
                                                        TRASH_BLOCK)
        ids = np.zeros((1, c_bucket), np.int64)
        ids[0, :n] = req.prompt[start:start + n]
        values = {"ids": ids, "table_row": self._tables[slot]}
        for name, v in (("start", start), ("true_end", start + n),
                        ("last_idx", s - 1 - start), ("cow_src", cow_src),
                        ("cow_dst", cow_dst)):
            values[name] = np.asarray(v, np.int64)
        any_sample = req.do_sample and is_last
        if any_sample:
            values.update(self._samp_values([req]))

        spec, bs, mode, params, cache, gen = self._step_state

        def body(a):
            return _chunk_prefill_step(
                spec, bs, mode, is_last, ctx_pages, params, cache, a["ids"],
                a["start"], a["true_end"], a["last_idx"], a["table_row"],
                a["cow_src"], a["cow_dst"], (any_sample, a, gen))

        tok = None
        with obs.span("serving.chunk_prefill") as rec:
            t_run = time.perf_counter()
            out = self._call("serving.chunk_prefill", c_bucket, any_sample,
                             (ctx_pages, is_last), values, body)
            entry = self._last_entry
            if is_last:
                tok = out.tolist()[0]
            else:
                mark = _end_mark(self.device)
        t_end = time.perf_counter()
        fl = req._flight
        fl.chunks += 1
        args = {"start": int(start), "tokens": int(n),
                "last": bool(is_last), "cow": cow is not None}
        if is_last:
            entry.observe(t_end - t_run)
            self._close_chunks()
            fl.add_span("prefill_chunk", t_run, t_end, args)
        else:
            self._open_chunks.append((fl, rec, t_run, args, entry, mark))
        if cow is not None:
            # the copy is enqueued before any later use of the pool, so
            # the admission-time ref that kept the source from eviction
            # can go
            self.prefix_cache.release([cow_src])
            self._slot_extra_refs[slot].remove(cow_src)
            self._update_pool_gauges()
        req.prefill_pos = start + n
        self._m_chunks.inc()
        self._m_prefill_tokens.inc(n)
        return tok

    def _close_chunks(self):
        """End the spans of the chunks that emitted no token (their
        flight span and their `obs.span` record) at the times their work
        ended on the device (`_ended_at`), and observe those walls into
        their programs' cost-ledger rows. Called after every read-back,
        where the device has caught up, and before a trace is written."""
        if not self._open_chunks:
            return
        ends = _ended_at([c[-1] for c in self._open_chunks], self.device)
        for (fl, rec, t_run, args, entry, _), t_end in zip(self._open_chunks,
                                                           ends):
            rec["seconds"] = t_end - t_run
            entry.observe(t_end - t_run)
            fl.add_span("prefill_chunk", t_run, t_end, args)
        self._open_chunks.clear()

    def _decode(self, active):
        """One decode tick of the `active` slots, compacted to their slot
        bucket: the program of `_decode_step`, keyed by (bucket,
        any_sample); the tick's span ends at the tokens' read-back."""
        t0 = time.perf_counter()
        bucket = min(default_buckets(len(active)), self.max_slots)
        reqs = [self._slot_req[i] for i in active]
        pad = bucket - len(active)
        tok = np.array([r.tokens[-1] for r in reqs] + [0] * pad, np.int64)
        pos = np.concatenate([self._slot_pos[active],
                              np.zeros(pad, np.int64)])
        tables = np.concatenate(
            [self._tables[active],
             np.full((pad, self.pages), TRASH_BLOCK, np.int32)])
        values = {"tok": tok, "pos": pos, "tables": tables}
        any_sample = any(r.do_sample for r in reqs)
        if any_sample:
            values.update(self._samp_values(reqs, pad))

        spec, bs, mode, params, cache, gen = self._step_state

        def body(a):
            return _decode_step(spec, bs, mode, params, cache, a["tok"],
                                a["pos"], a["tables"], (any_sample, a, gen))

        t_run = time.perf_counter()
        nxt = self._call("serving.decode", bucket, any_sample, (), values,
                         body).tolist()
        t_end = time.perf_counter()
        self._last_entry.observe(t_end - t_run)
        self._close_chunks()
        step_wall = t_end - t0
        self.flight.tick_span("decode_tick", t_run, t_end,
                              active=len(active), bucket=int(bucket))
        self._m_decode_step.observe(step_wall)
        # TPOT is per token: one observation per emitted token
        tpot = step_wall / len(active)
        for _ in active:
            self._m_tpot.observe(tpot)
        emitted = []
        for j, slot in enumerate(active):
            req = self._slot_req[slot]
            t = int(nxt[j])
            req.tokens.append(t)
            fl = req._flight
            fl.tokens += 1
            fl.last_token_s = t_end
            self._slot_pos[slot] += 1
            done = self._check_done(req, t)
            emitted.append((req.rid, t, done))
            if done:
                self._finish(slot)
        self._m_decode_tokens.inc(len(active))
        return emitted

    def _spec_proposals(self, active):
        """The proposer's candidates for every opted-in active slot.
        Returns (spec_slots, proposals): only slots with a non-empty
        proposal speculate this tick; the rest decode normally."""
        if self.proposer is None:
            return [], []
        cand = [i for i in active
                if self._slot_req[i].speculative is not False]
        if not cand:
            return [], []
        reqs = [self._slot_req[i] for i in cand]
        props = self.proposer.proposals(self, cand, reqs)
        spec_slots, out = [], []
        for slot, p in zip(cand, props):
            p = np.asarray(p, np.int64).reshape(-1)
            if p.size:
                spec_slots.append(slot)
                out.append(p)
        return spec_slots, out

    def _spec_decode(self, slots, proposals):
        """One verify window for every speculating slot: the program of
        `_spec_verify_step`, keyed by (slot bucket, any_sample, (k,)); the
        host reads acc and tgt once, emits each slot's accepted prefix and
        its correction or bonus token, and advances `_slot_pos` past the
        emitted tokens only (the rollback). An eos inside the window ends
        the request there, and max_new_tokens truncates the window."""
        t0 = time.perf_counter()
        k = self.proposer.k
        width = k + 1
        bucket = min(default_buckets(len(slots)), self.max_slots)
        reqs = [self._slot_req[i] for i in slots]
        pad = bucket - len(slots)
        toks = np.zeros((bucket, width), np.int64)
        limit = np.zeros(bucket, np.int64)
        for j, (slot, req, prop) in enumerate(zip(slots, reqs, proposals)):
            toks[j, 0] = req.tokens[-1]
            n = min(len(prop), k)
            toks[j, 1:1 + n] = prop[:n]
            if n < k:    # a short proposal pads by repeating (rejected)
                toks[j, 1 + n:] = toks[j, n]
            limit[j] = len(self._slot_blocks[slot]) * self.block_size
        pos = np.concatenate([self._slot_pos[slots],
                              np.zeros(pad, np.int64)])
        tables = np.concatenate(
            [self._tables[slots],
             np.full((pad, self.pages), TRASH_BLOCK, np.int32)])
        values = {"toks": toks, "pos": pos, "tables": tables,
                  "limit": limit}
        any_sample = any(r.do_sample for r in reqs)
        if any_sample:
            values.update(self._samp_values(reqs, pad))

        spec, bs, mode, params, cache, gen = self._step_state

        def body(a):
            return _spec_verify_step(spec, bs, mode, params, cache,
                                     a["toks"], a["pos"], a["tables"],
                                     a["limit"], (any_sample, a, gen))

        t_run = time.perf_counter()
        acc, tgt = self._call("serving.spec_verify", bucket, any_sample,
                              (k,), values, body)
        acc, tgt = acc.tolist(), tgt.tolist()
        t_end = time.perf_counter()
        self._last_entry.observe(t_end - t_run)
        self._close_chunks()
        step_wall = t_end - t0
        self._m_decode_step.observe(step_wall)
        emitted = []
        n_tokens = n_accepted = 0
        for j, slot in enumerate(slots):
            req = self._slot_req[slot]
            prop = proposals[j]
            plen = min(len(prop), k)
            a = 0
            while a < plen and acc[j][a]:
                a += 1
            new = [int(t) for t in prop[:a]] + [int(tgt[j][a])]
            new = new[: req.max_new_tokens - len(req.tokens)]
            if req.eos_token_id >= 0:
                for i, t in enumerate(new):
                    if t == req.eos_token_id:
                        new = new[: i + 1]
                        break
            done = False
            for t in new:
                req.tokens.append(t)
                done = self._check_done(req, t)
            self._slot_pos[slot] += len(new)
            fl = req._flight
            fl.tokens += len(new)
            fl.last_token_s = t_end
            n_tokens += len(new)
            n_accepted += a
            self._m_spec_accept_rate.observe(a / plen if plen else 0.0)
            self._m_spec_emitted.observe(len(new))
            emitted.extend((req.rid, t, done and i == len(new) - 1)
                           for i, t in enumerate(new))
            if done:
                self._finish(slot)
        self._m_spec_windows.inc(len(slots))
        self._m_spec_proposed.inc(sum(min(len(p), k) for p in proposals))
        self._m_spec_accepted.inc(n_accepted)
        self._m_decode_tokens.inc(n_tokens)
        tpot = step_wall / max(n_tokens, 1)
        for _ in range(n_tokens):
            self._m_tpot.observe(tpot)
        self.flight.tick_span("verify_window", t_run, t_end,
                              active=len(slots), k=int(k),
                              accepted=int(n_accepted),
                              emitted=int(n_tokens), bucket=int(bucket))
        return emitted

    @staticmethod
    def _samp_values(reqs, pad=0):
        """Per-slot sampling params as host arrays, a sampling program's
        inputs (padded rows greedy — their tokens are discarded)."""
        return {
            "do_sample": np.array([r.do_sample for r in reqs] + [False] * pad),
            "temperature": np.array([r.temperature for r in reqs]
                                    + [1.0] * pad, np.float32),
            "top_k": np.array([r.top_k for r in reqs] + [0] * pad, np.int32),
            "top_p": np.array([r.top_p for r in reqs] + [1.0] * pad,
                              np.float32),
        }

    def _check_done(self, req, tok) -> bool:
        if req.eos_token_id >= 0 and tok == req.eos_token_id:
            req.finish_reason = "eos"
            return True
        if len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _finish(self, slot):
        """Copy-free release THROUGH THE PREFIX CACHE: the slot's fully
        written blocks are first published under their content hashes
        (the next request sharing this prompt, or this prompt plus this
        completion, hits them), then every block the slot holds is
        decref'd, a pending copy-on-write source included. Blocks other
        requests still reference survive; hash-mapped blocks at refcount
        0 park in the LRU; the rest free-list. The flight records the
        finish."""
        req = self._slot_req[slot]
        req.finished = True
        self.completed[req.rid] = np.asarray(req.tokens, np.int64)
        self.finish_reasons[req.rid] = req.finish_reason or "length"
        self.flight.finish(req.rid, time.perf_counter(),
                           self.finish_reasons[req.rid])
        self._m_flight_requests.set(len(self.flight._flights))
        self._register_full_blocks(slot)
        self.prefix_cache.release(self._slot_blocks[slot]
                                  + self._slot_extra_refs[slot])
        self._slot_extra_refs[slot] = []
        self._slot_chunk.pop(slot, None)
        self._slot_blocks[slot] = []
        self._slot_req[slot] = None
        self._slot_pos[slot] = 0
        self._tables[slot] = TRASH_BLOCK
        self._m_completed.inc()
        if self.proposer is not None:
            self.proposer.finish(slot)
        self._update_pool_gauges()


def generate_paged(model, ids, max_new_tokens, do_sample=False,
                   temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                   seed=None, device=None, **engine_kwargs):
    """Run a rectangular batch through a ServingEngine and return tokens
    [B, max_new_tokens] int64 (rows that hit eos early are padded with
    eos, -1 without one). `engine_kwargs` reach the engine (for example
    kv_cache_dtype=, weight_quant=). seed=None draws a fresh seed from
    torch's global generator, so repeated unseeded sampling calls
    differ."""
    ids = np.asarray(ids, np.int64)
    b = ids.shape[0]
    if seed is None:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,)).item())
    eng = ServingEngine(model, max_slots=max(1, b), seed=seed, device=device,
                        **engine_kwargs)
    order = [eng.add_request(
        ids[i], max_new_tokens=max_new_tokens, do_sample=do_sample,
        temperature=temperature, top_k=top_k, top_p=top_p,
        eos_token_id=eos_token_id) for i in range(b)]
    done = eng.run()
    pad = -1 if eos_token_id is None else int(eos_token_id)
    out = np.full((b, int(max_new_tokens)), pad, np.int64)
    for i, rid in enumerate(order):
        toks = done[rid]
        out[i, :len(toks)] = toks
    return out
