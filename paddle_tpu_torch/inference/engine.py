"""Continuous-batching serving engine over the paged KV cache.

Port of paddle_tpu/inference/engine.py: a fixed SLOT array, block-granular
KV allocation with admission control, and requests that join freed slots
mid-flight instead of waiting for a whole static batch to drain.

Same contract as the reference, different mechanism. Per scheduler tick
the engine runs a PREFILL for each joining request (the prompt padded to
its length bucket; attention through the flash kernel, the prompt's K/V
scattered into its pages) and ONE DECODE step advancing every active slot
one token (the slot state compacted to a slot-count bucket; each layer
appends its K/V through the block tables and attends through the paged
decode kernel). Where the reference traced and cached one XLA program
per bucket, donated the pool and scanned stacked layer weights, the port
runs eager torch, updates the pool in place and loops over layers in
Python; the bucket sizes are the reference's, so the same prompt and slot
shapes reach the kernels.

Scheduling (admission, eos/length/deadline finish, block free/reuse,
stats) is host-side Python, as in the reference.

Not ported yet, refused with NotImplementedError naming the ROADMAP item:
prefix caching, chunked prefill, speculative decoding, int8/int4 KV,
weight-only quantization, GPT models, and the metrics registry and
flight recorder. The engine's defaults are prefix cache off and whole-
prompt prefill; greedy tokens do not depend on either setting in the
reference.

Sampling uses a `torch.Generator` on the engine's device seeded from
`seed`: sampled tokens cannot reproduce JAX's random bits, greedy rows
stay an exact argmax.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from ..core.flags import flag
from ..jit.api import default_buckets
from ..ops._cuda_common import ceil_to as _ceil_to
from ..ops._cuda_common import resolve_device
from ..ops.paged_decode import paged_decode_attention
from ..text.generation import (_extract_llama, _layer_forward_prefill,
                               _logits, _mm, _rms_norm, _rope,
                               _spec_from_config)
from ..text.paged_cache import (TRASH_BLOCK, BlockAllocator, PagedKVCache,
                                append_token, blocks_for, scatter_prefill)


_ITEM_PREFIX = "2, 'Prefix cache, chunked prefill and the chunk program'"
_ITEM_QUANT = "3, 'Quantized serving'"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP Queue 1, "
        f"item {item})")


# ------------------------------------------------------ batched sampling

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
    """Per-slot (greedy | temperature/top-k/top-p) sampling over [B, V];
    greedy rows are an exact argmax. Sampled rows draw by Gumbel-max from
    `generator`."""
    greedy = logits.argmax(dim=-1)
    lg = _filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = (lg + gumbel).argmax(dim=-1)
    return torch.where(do_sample, sampled, greedy)


# --------------------------------------------------- paged decode layers

def _paged_attn(q, k_new, v_new, kc, vc, tables, pos, block_size):
    """Append this step's K/V through the block tables (in place), then
    paged decode attention over lens = pos + 1 (the just-written token
    included). kc/vc are one layer's pool slice [N, Hkv, bs, D]."""
    b = q.shape[0]
    blk = tables[torch.arange(b, device=q.device), pos // block_size]
    off = pos % block_size
    append_token(kc, k_new, blk, off)
    append_token(vc, v_new, blk, off)
    lens = (pos + 1).to(torch.int32)
    return paged_decode_attention(q.contiguous(), kc, vc, tables, lens)


def _paged_layer_llama(x, lw, kc, vc, pos, tables, spec, cos, sin,
                       block_size):
    """One LLaMA block for seq-1 queries at per-slot positions against the
    paged cache. x [B, H]; kc/vc one layer's pool slice."""
    b, h = x.shape
    hn = _rms_norm(x, lw["input_ln"], spec.rms_eps)
    q = _mm(hn, lw["q"]).reshape(b, spec.num_heads, spec.head_dim)
    k = _mm(hn, lw["k"]).reshape(b, spec.num_kv_heads, spec.head_dim)
    v = _mm(hn, lw["v"]).reshape(b, spec.num_kv_heads, spec.head_dim)
    c = cos[pos][:, None]                       # [B, 1, D]
    sn = sin[pos][:, None]
    q = _rope(q, c, sn)
    k = _rope(k, c, sn)
    out = _paged_attn(q, k, v, kc, vc, tables, pos, block_size)
    x = x + _mm(out.reshape(b, spec.num_heads * spec.head_dim), lw["o"])
    hn = _rms_norm(x, lw["post_ln"], spec.rms_eps)
    return x + _mm(F.silu(_mm(hn, lw["gate"])) * _mm(hn, lw["up"]),
                   lw["down"])


# ------------------------------------------------------- step functions

@torch.no_grad()
def _decode_step(spec, block_size, params, cache, tok, pos, tables):
    """One decode step for a compacted slot bucket: every row consumes its
    token, appends K/V through its block table and attends over its own
    length. Returns f32 logits [B, V]."""
    x = params["embed"][tok]                                # [B, H]
    cos, sin = params["rope_cos"], params["rope_sin"]
    for li, lw in enumerate(params["layers"]):
        x = _paged_layer_llama(x, lw, cache.k[li], cache.v[li], pos, tables,
                               spec, cos, sin, block_size)
    return _logits(x, params, spec)


@torch.no_grad()
def _prefill_step(spec, block_size, params, cache, ids, true_len,
                  table_row):
    """Prefill one joining request: full-prompt forward (flash kernel),
    page-scatter the prompt K/V through the slot's block table, and return
    the f32 logits [1, V] of the last REAL prompt position."""
    x = params["embed"][ids]                                # [1, S, H]
    cos, sin = params["rope_cos"], params["rope_sin"]
    ks, vs = [], []
    for lw in params["layers"]:
        x, (k, v) = _layer_forward_prefill(x, lw, spec, cos, sin)
        ks.append(k[0])
        vs.append(v[0])
    scatter_prefill(cache.k, torch.stack(ks), true_len, table_row,
                    block_size)
    scatter_prefill(cache.v, torch.stack(vs), true_len, table_row,
                    block_size)
    return _logits(x[:, true_len - 1], params, spec)


# ------------------------------------------------------------ scheduler

class Request:
    """One generation request riding the engine."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "do_sample",
                 "temperature", "top_k", "top_p", "eos_token_id",
                 "tokens", "arrival_s", "admitted_s", "first_token_s",
                 "finished", "max_time_ms", "deadline_s", "finish_reason")

    def __init__(self, rid, prompt, max_new_tokens, do_sample, temperature,
                 top_k, top_p, eos_token_id, max_time_ms=None):
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
    `add_request`/`step`/`run`.

    The model must lie on `device` ("cuda" unless the caller asks for
    another; no card -> RuntimeError)."""

    def __init__(self, model, max_slots=None, kv_block_size=None,
                 num_kv_blocks=None, kv_cache_dtype=None,
                 max_model_len=None, seed=0, admission="continuous",
                 prefix_cache=None, chunked_prefill_tokens=None,
                 prefix_cache_max_blocks=None, spec_decode=None,
                 weight_quant=None, device=None):
        self.device = resolve_device(device)
        if getattr(model, "_gen_arch", "llama") != "llama":
            raise _not_ported("serving a GPT model", "6, 'GPT with K6'")
        if prefix_cache or prefix_cache_max_blocks is not None:
            raise _not_ported("prefix caching", _ITEM_PREFIX)
        if chunked_prefill_tokens:
            raise _not_ported("chunked prefill", _ITEM_PREFIX)
        if spec_decode not in (None, "off"):
            raise _not_ported("speculative decoding",
                              "4, 'Speculative decoding'")
        if weight_quant in ("int8", "int4"):
            raise _not_ported(f"{weight_quant} weight-only quantization",
                              _ITEM_QUANT)
        if weight_quant not in (None, "none"):
            raise ValueError(f"weight_quant must be 'none', 'int8' or "
                             f"'int4', got {weight_quant!r}")
        mode = str(kv_cache_dtype or flag("FLAGS_kv_cache_dtype"))
        if mode in ("int8", "int4"):
            raise _not_ported(f"{mode} KV cache", _ITEM_QUANT)
        if mode != "model":
            raise ValueError(f"kv_cache_dtype must be 'model', 'int8' or "
                             f"'int4', got {mode!r}")
        mdev = model.device
        if mdev.type != self.device.type or (
                self.device.index is not None
                and mdev.index != self.device.index):
            raise ValueError(f"model lies on {mdev}, engine device is "
                             f"{self.device}")
        cfg = model.config
        self.spec = _spec_from_config(cfg)
        self.params = _extract_llama(model)
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
            self.params["embed"].dtype, self.device)
        self.allocator = BlockAllocator(int(num_kv_blocks))
        if admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission mode {admission!r}")
        self.admission = admission
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
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._decode_time_s = 0.0
        self._prefill_time_s = 0.0
        self._requests_completed = 0
        self._warmed = False

    # ------------------------------------------------------------- API
    def add_request(self, prompt, max_new_tokens=32, do_sample=False,
                    temperature=1.0, top_k=0, top_p=1.0,
                    eos_token_id=None, max_time_ms=None) -> int:
        """Queue a request. Raises ValueError when it could NEVER be served
        (context or pool too small); otherwise it waits for admission.
        `max_time_ms` is a wall-clock deadline from arrival: when it
        expires the request finishes with reason ``"timeout"`` (the tokens
        produced so far are its result) and its blocks are freed."""
        if torch.is_tensor(prompt):
            prompt = prompt.cpu().numpy()
        prompt = np.asarray(prompt, np.int64).reshape(-1).astype(np.int32)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be positive")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_model_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds the engine context "
                f"({self.max_model_len} = max_position_embeddings rounded "
                f"down to whole {self.block_size}-token kv blocks)")
        need = blocks_for(total, self.block_size)
        if need > self.allocator.num_blocks - 1:
            raise ValueError(
                f"request needs {need} kv blocks but the pool only has "
                f"{self.allocator.num_blocks - 1}")
        if max_time_ms is not None and float(max_time_ms) <= 0:
            raise ValueError("max_time_ms must be positive")
        rid = self._next_id
        self._next_id += 1
        self._waiting.append(Request(rid, prompt, max_new_tokens, do_sample,
                                     temperature, top_k, top_p,
                                     eos_token_id, max_time_ms=max_time_ms))
        return rid

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    def has_work(self) -> bool:
        return bool(self._waiting) or self.num_active > 0

    def step(self):
        """One scheduler tick: expire deadlined requests, admit (and
        prefill) joining requests, then advance every active slot one
        token. Returns a list of (request_id, token, finished) for tokens
        emitted this tick; a request finished by its deadline emits a
        terminal ``(request_id, None, True)``."""
        emitted = self._expire()
        emitted.extend(self._admit())
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if active:
            emitted.extend(self._decode(active))
            self.steps += 1
            self.active_slot_steps += len(active)
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
        return dict(self.completed)

    def stats(self) -> dict:
        """Scheduler counters and timings (host wall clock, seconds)."""
        util = (self.active_slot_steps / (self.steps * self.max_slots)
                if self.steps else 0.0)
        return {"steps": self.steps,
                "decode_tokens": self._decode_tokens,
                "prefill_tokens": self._prefill_tokens,
                "decode_time_s": self._decode_time_s,
                "prefill_time_s": self._prefill_time_s,
                "slot_utilization": round(util, 4),
                "ttft_s": list(self.ttfts),
                "queue_wait_s": list(self.queue_waits),
                "requests_completed": self._requests_completed,
                "kv_pool_blocks": self.allocator.num_blocks,
                "kv_pool_free": self.allocator.available}

    def finish_warmup(self):
        """Declare the engine warm (the reference tags later compiles as
        steady-state retraces; eager torch compiles nothing, so this only
        records the state)."""
        self._warmed = True
        return self

    @property
    def warmed(self) -> bool:
        return self._warmed

    # ------------------------------------------------------- scheduling
    def _expire(self):
        """Active slots past their deadline finish now with reason
        "timeout" (blocks freed); queued requests whose deadline lapsed
        finish empty without taking a slot. Returns the terminal
        ``(rid, None, True)`` events."""
        now = time.perf_counter()
        emitted = []
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.expired(now):
                req.finish_reason = "timeout"
                self._finish(slot)
                emitted.append((req.rid, None, True))
        expired_waiting = [r for r in self._waiting if r.expired(now)]
        if expired_waiting:
            self._waiting = deque(r for r in self._waiting
                                  if not r.expired(now))
            for req in expired_waiting:
                req.finished = True
                req.finish_reason = "timeout"
                self.completed[req.rid] = np.asarray(req.tokens, np.int64)
                self.finish_reasons[req.rid] = "timeout"
                self._requests_completed += 1
                emitted.append((req.rid, None, True))
        return emitted

    def _admit(self):
        """Admission control: head-of-line requests enter freed slots only
        when the pool covers their whole block budget (prompt + max new
        tokens), so admitted requests never run out of cache mid-flight;
        each admitted prompt is prefilled whole right here. Static mode
        additionally waits for the whole engine to drain."""
        if self.admission == "static" and self.num_active:
            return
        for slot in range(self.max_slots):
            if not self._waiting or self._slot_req[slot] is not None:
                continue
            req = self._waiting[0]
            s = req.prompt.size
            ids = self.allocator.alloc(
                blocks_for(s + req.max_new_tokens, self.block_size))
            if ids is None:
                break           # pool full: wait for releases
            self._waiting.popleft()
            req.admitted_s = time.perf_counter()
            self.queue_waits.append(req.queue_wait_s)
            self._slot_req[slot] = req
            self._slot_blocks[slot] = ids
            self._tables[slot] = TRASH_BLOCK
            self._tables[slot, :len(ids)] = ids
            tok, done = self._prefill(slot, req)
            yield (req.rid, tok, done)
            if done:
                self._finish(slot)

    def _prefill(self, slot, req):
        s = req.prompt.size
        bucket = min(_ceil_to(default_buckets(s), self.block_size),
                     self.max_model_len)
        bucket = max(bucket, _ceil_to(s, self.block_size))
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s] = req.prompt
        dev = self.device
        lg = _prefill_step(self.spec, self.block_size, self.params,
                           self.cache, torch.from_numpy(ids).to(dev), s,
                           torch.from_numpy(self._tables[slot]).to(dev))
        tok = int(self._sample(lg, [req])[0])
        req.first_token_s = time.perf_counter()
        self._prefill_time_s += req.prefill_s
        self.ttfts.append(req.ttft_s)
        self._prefill_tokens += s
        req.tokens.append(tok)
        self._slot_pos[slot] = s
        return tok, self._check_done(req, tok)

    def _decode(self, active):
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
        dev = self.device
        lg = _decode_step(self.spec, self.block_size, self.params,
                          self.cache, torch.from_numpy(tok).to(dev),
                          torch.from_numpy(pos).to(dev),
                          torch.from_numpy(tables).to(dev))
        nxt = self._sample(lg, reqs, pad)
        self._decode_time_s += time.perf_counter() - t0
        emitted = []
        for j, slot in enumerate(active):
            req = self._slot_req[slot]
            t = int(nxt[j])
            req.tokens.append(t)
            self._slot_pos[slot] += 1
            done = self._check_done(req, t)
            emitted.append((req.rid, t, done))
            if done:
                self._finish(slot)
        self._decode_tokens += len(active)
        return emitted

    def _sample(self, logits, reqs, pad=0):
        """Next tokens (host list) for the logits rows of `reqs` (+ `pad`
        greedy padding rows). An all-greedy batch is a bare argmax."""
        if not any(r.do_sample for r in reqs):
            return logits.argmax(dim=-1).tolist()
        samp = self._samp_arrays(reqs, pad)
        return _sample_batched(logits, self._gen, samp["do_sample"],
                               samp["temperature"], samp["top_k"],
                               samp["top_p"]).tolist()

    def _samp_arrays(self, reqs, pad=0):
        """Per-slot sampling params as batched device tensors (padded rows
        greedy — their tokens are discarded)."""
        dev = self.device
        return {
            "do_sample": torch.tensor(
                [r.do_sample for r in reqs] + [False] * pad, device=dev),
            "temperature": torch.tensor(
                [r.temperature for r in reqs] + [1.0] * pad,
                dtype=torch.float32, device=dev),
            "top_k": torch.tensor([r.top_k for r in reqs] + [0] * pad,
                                  dtype=torch.int32, device=dev),
            "top_p": torch.tensor([r.top_p for r in reqs] + [1.0] * pad,
                                  dtype=torch.float32, device=dev),
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
        """Copy-free release: the slot's blocks go back to the free list;
        their stale contents are never read again."""
        req = self._slot_req[slot]
        req.finished = True
        self.completed[req.rid] = np.asarray(req.tokens, np.int64)
        self.finish_reasons[req.rid] = req.finish_reason or "length"
        self.allocator.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._slot_req[slot] = None
        self._slot_pos[slot] = 0
        self._tables[slot] = TRASH_BLOCK
        self._requests_completed += 1


def generate_paged(model, ids, max_new_tokens, do_sample=False,
                   temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                   seed=None, device=None, **engine_kwargs):
    """Run a rectangular batch through a ServingEngine and return tokens
    [B, max_new_tokens] int64 (rows that hit eos early are padded with
    eos, -1 without one). seed=None draws a fresh seed from torch's global
    generator, so repeated unseeded sampling calls differ."""
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
