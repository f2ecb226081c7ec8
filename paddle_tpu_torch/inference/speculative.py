"""Speculative decoding: the proposers and the static engine's speculative
loop.

Port of paddle_tpu/inference/speculative.py. A cheap draft proposes K
candidate tokens, the target model scores all K + 1 candidate positions
in one pass (the verify program in inference/engine.py, one weight sweep
like a single decode tick), and the accept/reject rule emits between 1
and K + 1 tokens per sweep:

  * greedy rows accept the longest prefix of proposals that matches the
    verifier's own argmax, then emit its correction (or, when everything
    matched, its bonus token): the emitted stream is token-identical to
    the non-speculative engine by construction;
  * sampling rows accept proposal x with probability p(x) under the row's
    filtered distribution and resample a rejection from the residual
    (Leviathan et al.), so the emitted marginal stays p.

This module holds the `SpecConfig` surface, the proposers behind one
interface (the model-free n-gram prompt lookup, the draft model with its
own dense cache, and the test fixtures), and the static engine's
speculative loop (`generate_static_spec`).

Rollback is bookkeeping: rejected candidates' K/V stays in the cache, but
the engine does not advance a slot's position past what it emitted, reads
are bounded by position masks, and the next window rewrites the same
positions before any mask exposes them. Prefix-cache registration covers
emitted tokens only.

The draft model's programs go through the engine's program table (sites
"serving.spec_draft_prefill" and "serving.spec_draft_propose"), so on a
card each is a CUDA graph captured at its key's first call. Its dense
cache is [L, max_slots + 1, T + 1, Hkv, D]: row 0 is a trash row (a
program's dry run writes there) and the slots are rows 1..max_slots;
index T of the time axis is the parked trash position. Target and draft
are each a LLaMA or a GPT (the block math of text/generation.py, by the
model's `_gen_arch`), in any pairing with one vocabulary, as the
reference's.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..jit.api import default_buckets
from ..ops.flash_attention import flash_attention_fwd
from ..text.generation import (_cached_block, _dense_attention, _embed,
                               _extract, _layer_forward_prefill, _logits,
                               _rope_at, _rope_full, _spec_for, _tensors)


# ------------------------------------------------------------ config

@dataclasses.dataclass(eq=False)
class SpecConfig:
    """Speculative-decoding selection surface (FLAGS_spec_decode is the
    string shorthand: engine(spec_decode="ngram") == SpecConfig("ngram")).

    method       "ngram" (model-free prompt lookup) | "draft" (a small
                 LLaMA or GPT proposes; pass it as draft_model)
    k            speculation depth, tokens proposed per verify window
                 (None reads FLAGS_spec_k)
    draft_model  the proposer model for method="draft"
    max_ngram    longest suffix n-gram the lookup proposer matches
    proposer     an explicit Proposer instance (fixtures); when set,
                 `method` is ignored
    """
    method: str = "ngram"
    k: int | None = None
    draft_model: object = None
    max_ngram: int = 3
    proposer: object = None

    def __post_init__(self):
        from ..core.flags import flag

        if self.k is None:
            self.k = int(flag("FLAGS_spec_k"))
        self.k = int(self.k)
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if self.proposer is not None:
            return
        if self.method not in ("ngram", "draft"):
            raise ValueError(
                f"unknown speculative method {self.method!r} "
                "(expected 'ngram' or 'draft')")
        if self.method == "draft" and self.draft_model is None:
            raise ValueError(
                "SpecConfig(method='draft') needs draft_model=<model>")


def make_proposer(cfg: SpecConfig):
    """Resolve a SpecConfig into its Proposer instance."""
    if cfg.proposer is not None:
        return cfg.proposer
    if cfg.method == "ngram":
        return NgramProposer(cfg.k, max_ngram=cfg.max_ngram)
    return DraftModelProposer(cfg.draft_model, cfg.k)


# ------------------------------------------------- n-gram prompt lookup

def propose_ngram(context, k, max_ngram=3, min_ngram=1):
    """Model-free prompt-lookup proposal: match the longest suffix n-gram
    of `context` (prompt + generated history) against an earlier
    occurrence and propose the up-to-k tokens that followed it. Among the
    matches, the most recent one with a full k-token continuation wins;
    if none has k tokens left, the earliest match. Returns an int64 array
    of 0..k tokens; empty means "no match, decode this one normally"."""
    ctx = np.asarray(context, np.int64).reshape(-1)
    n = int(ctx.size)
    k = int(k)
    if k < 1 or n < min_ngram + 1:
        return np.zeros(0, np.int64)
    for g in range(min(int(max_ngram), n - 1), min_ngram - 1, -1):
        pat = ctx[n - g:]
        # windows over ctx[:n-1]: every start strictly before the
        # suffix's own position, so the tail never matches itself
        wins = np.lib.stride_tricks.sliding_window_view(ctx[:n - 1], g)
        hits = np.nonzero((wins == pat).all(axis=1))[0]
        if hits.size:
            full = hits[hits + g + k <= n]
            i = int(full[-1]) if full.size else int(hits[0])
            return ctx[i + g: i + g + k].copy()
    return np.zeros(0, np.int64)


# ---------------------------------------------------- proposer interface

class Proposer:
    """One draft proposer driving the verify windows of a ServingEngine.

    Per scheduler tick the engine calls `proposals(engine, slots, reqs)`,
    which returns one int64 array (possibly empty) per slot: candidate
    continuations of `req.prompt + req.tokens`. An empty proposal opts the
    slot out of speculation for this tick. `finish(slot)` drops a finished
    slot's state. Proposers see only emitted tokens (`req.tokens`)."""

    k = 0

    def proposals(self, engine, slots, reqs):
        raise NotImplementedError

    def finish(self, slot):
        pass


class NgramProposer(Proposer):
    """Prompt-lookup proposer: no device work, wins on repetitive
    streams."""

    def __init__(self, k, max_ngram=3):
        self.k = int(k)
        self.max_ngram = int(max_ngram)

    def proposals(self, engine, slots, reqs):
        return [propose_ngram(
            np.concatenate([r.prompt.astype(np.int64),
                            np.asarray(r.tokens, np.int64)]),
            self.k, self.max_ngram) for r in reqs]


class AlwaysRejectProposer(Proposer):
    """Fixture: proposes `last + 1 + i (mod vocab)`, almost never the
    verifier's argmax, so acceptance collapses while greedy parity holds
    through the correction path."""

    def __init__(self, k):
        self.k = int(k)

    def proposals(self, engine, slots, reqs):
        v = int(engine.params["embed"].shape[0])
        return [(int(r.tokens[-1]) + 1
                 + np.arange(self.k, dtype=np.int64)) % v for r in reqs]


class ReplayProposer(Proposer):
    """Fixture: replays a known completion per request id, so every
    window accepts all K proposals."""

    def __init__(self, k, by_rid):
        self.k = int(k)
        self.by_rid = {int(r): np.asarray(t, np.int64).reshape(-1)
                       for r, t in by_rid.items()}

    def proposals(self, engine, slots, reqs):
        out = []
        for r in reqs:
            seq = self.by_rid.get(r.rid)
            if seq is None:
                out.append(np.zeros(0, np.int64))
            else:
                done = len(r.tokens)
                out.append(seq[done: done + self.k])
        return out


# ------------------------------------------------ draft-model proposer

def _spec_and_params(model):
    """(block spec, serving params) of a LLaMA or GPT model, the
    extraction the serving engine runs on the target."""
    spec = _spec_for(model)
    return spec, _extract(model, spec)


@torch.no_grad()
def _draft_prefill_step(dspec, params, kc, vc, ids, row):
    """Prefill one request's prompt into the draft cache's row `row` (a
    0-dim tensor: slot + 1). ids [1, S_bucket] right-padded; pad positions
    write K/V past the true length that the ingest overwrites before any
    mask exposes it."""
    x = _embed(params, dspec, ids)
    cos, sin = _rope_full(params, dspec)
    s = ids.shape[1]
    idx = row.reshape(1)
    for li, lw in enumerate(params["layers"]):
        x, (k, v) = _layer_forward_prefill(x, lw, dspec, cos, sin,
                                           attention=flash_attention_fwd)
        kc[li, :, :s].index_copy_(0, idx, k.to(kc.dtype))
        vc[li, :, :s].index_copy_(0, idx, v.to(vc.dtype))


@torch.no_grad()
def _draft_propose_step(dspec, steps, params, kc, vc, pend, plen, pos):
    """Ingest-then-propose for every draft row in one program: `steps`
    seq-1 time steps; row b's step t consumes its pending emitted token
    pend[b, t] while t < plen[b] (catching the draft cache up with the
    verified stream), then runs on its own argmax. Rows with plen 0 are
    inactive: their writes park on the trash position. Returns the argmax
    tokens [B, steps]; the proposal of row b is greedy[b, plen - 1 :
    plen - 1 + k]. Row b of the inputs is cache row b + 1."""
    b, w = pend.shape
    t_trash = kc.shape[2] - 1
    active = plen > 0
    rows = torch.arange(b, device=pend.device)
    kv_pos = torch.arange(kc.shape[2], device=pend.device)

    def attend(li, wp, valid, q, k, v):
        # write at wp (inactive rows park on the trash position), attend
        # under `valid`
        kcl, vcl = kc[li, 1:], vc[li, 1:]
        kcl[rows, wp] = k.to(kcl.dtype)
        vcl[rows, wp] = v.to(vcl.dtype)
        return _dense_attention(q[:, None], kcl, vcl, valid)[:, 0]

    last = pend[:, 0]
    out = []
    for t in range(steps):
        tok = torch.where(t < plen, pend[:, min(t, w - 1)], last)
        p = pos + t
        wp = torch.where(active, torch.clamp(p, max=t_trash), t_trash)
        mp = torch.clamp(p, max=t_trash)
        valid = (kv_pos[None, :] <= mp[:, None])[:, None]      # [B, 1, T]
        x = _embed(params, dspec, tok, p)
        cos, sin = _rope_at(params, dspec, p)                  # [B, 1, D]
        for li, lw in enumerate(params["layers"]):
            x = _cached_block(x, lw, dspec, cos, sin,
                              functools.partial(attend, li, wp, valid))
        last = _logits(x, params, dspec).argmax(dim=-1)
        out.append(last)
    return torch.stack(out, dim=1)


class DraftModelProposer(Proposer):
    """Draft-model proposer: a small LLaMA or GPT on its own dense cache
    (module note), no slots taken from the target engine. Each tick it ingests
    the tokens the verifier emitted since the last tick and runs K greedy
    steps ahead. Its programs ride the engine's program table: one
    propose program per (k, draft weights) at the full slot count, one
    prefill program per prompt bucket."""

    def __init__(self, draft_model, k):
        if draft_model is None:
            raise ValueError("DraftModelProposer needs a draft model")
        self.k = int(k)
        if self.k < 1:
            raise ValueError("speculation depth k must be >= 1")
        self.dspec, self.dparams = _spec_and_params(draft_model)
        self._fp = hash(tuple((tuple(t.shape), str(t.dtype))
                              for t in _tensors(self.dparams)))
        self._bound = False

    def _bind(self, engine):
        """Size the draft cache to the engine (slot count, context); the
        draft's vocab must be the target's."""
        if self._bound:
            return
        tv = int(engine.params["embed"].shape[0])
        dv = int(self.dparams["embed"].shape[0])
        if tv != dv:
            raise ValueError(
                f"draft model vocab ({dv}) != target vocab ({tv}) — "
                "proposed token ids would not be target tokens")
        n = int(engine.max_slots)
        self._t = int(engine.max_model_len)
        sp = self.dspec
        shape = (sp.num_layers, n + 1, self._t + 1, sp.num_kv_heads,
                 sp.head_dim)
        emb = self.dparams["embed"]
        self._kc = torch.zeros(shape, dtype=emb.dtype, device=emb.device)
        self._vc = torch.zeros(shape, dtype=emb.dtype, device=emb.device)
        self._pos = np.zeros(n, np.int64)       # next draft write index
        self._ingested = np.zeros(n, np.int64)  # emitted tokens consumed
        self._slot_rid = [None] * n
        self._dead = np.zeros(n, bool)          # out of draft context
        self._bound = True

    def _prefill(self, engine, slot, req):
        s = int(req.prompt.size)
        bucket = min(max(default_buckets(s), s), self._t)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s] = req.prompt
        values = {"ids": ids, "row": np.asarray(slot + 1, np.int64)}
        dspec, params, kc, vc = self.dspec, self.dparams, self._kc, self._vc

        def body(a):
            _draft_prefill_step(dspec, params, kc, vc, a["ids"], a["row"])

        engine._call("serving.spec_draft_prefill", bucket, False,
                     (self._fp,), values, body)
        self._pos[slot] = s
        self._ingested[slot] = 0
        self._slot_rid[slot] = req.rid
        self._dead[slot] = False

    def proposals(self, engine, slots, reqs):
        self._bind(engine)
        k = self.k
        w = k + 1
        steps = 2 * k  # room to ingest a full window and run k ahead
        empty = np.zeros(0, np.int64)
        for slot, req in zip(slots, reqs):
            if self._slot_rid[slot] != req.rid:
                self._prefill(engine, slot, req)
        props: dict = {}
        pending: dict = {}
        for slot, req in zip(slots, reqs):
            if self._dead[slot]:
                props[slot] = empty
                continue
            if self._pos[slot] + steps + 1 >= self._t:
                # the draft context ends before the target's: stop
                # speculating this request, decode finishes it
                self._dead[slot] = True
                props[slot] = empty
                continue
            todo = list(req.tokens[int(self._ingested[slot]):])
            if todo:
                pending[slot] = todo
            else:
                props[slot] = empty
        dspec, params, kc, vc = self.dspec, self.dparams, self._kc, self._vc

        def body(a):
            return _draft_propose_step(dspec, steps, params, kc, vc,
                                       a["pend"], a["plen"], a["pos"])

        n = int(engine.max_slots)
        while pending:
            pend = np.zeros((n, w), np.int64)
            plen = np.zeros(n, np.int64)
            posa = np.zeros(n, np.int64)
            batch = sorted(pending.items())
            for slot, toks in batch:
                m = min(len(toks), w)
                pend[slot, :m] = toks[:m]
                plen[slot] = m
                posa[slot] = self._pos[slot]
            gs = engine._call("serving.spec_draft_propose", n, False,
                              (k, self._fp),
                              {"pend": pend, "plen": plen, "pos": posa},
                              body).cpu().numpy()
            for slot, toks in batch:
                m = int(plen[slot])
                self._pos[slot] += m
                self._ingested[slot] += m
                rest = toks[m:]
                if rest:
                    # more emitted tokens than one window carries: ingest
                    # in rounds until caught up
                    pending[slot] = rest
                else:
                    del pending[slot]
                    props[slot] = gs[slot, m - 1: m - 1 + k]
        return [props[slot] for slot in slots]

    def finish(self, slot):
        if self._bound:
            self._slot_rid[slot] = None
            self._dead[slot] = False


# ------------------------------- static single-program engine + spec

@torch.no_grad()
def _static_spec_prefill(dspec, t_total, params, ids, true_len):
    """Prefill for the static speculative loop: full-prompt forward, K/V
    into a [L, B, t_total, Hkv, D] cache, and the first token taken
    greedily from the last real prompt position."""
    x = _embed(params, dspec, ids)
    cos, sin = _rope_full(params, dspec)
    b, s = ids.shape
    kc = torch.zeros((dspec.num_layers, b, t_total, dspec.num_kv_heads,
                      dspec.head_dim), dtype=x.dtype, device=x.device)
    vc = torch.zeros_like(kc)
    for li, lw in enumerate(params["layers"]):
        x, (k, v) = _layer_forward_prefill(x, lw, dspec, cos, sin,
                                           attention=flash_attention_fwd)
        kc[li, :, :s] = k
        vc[li, :, :s] = v
    tok0 = _logits(x[:, true_len - 1], params, dspec).argmax(dim=-1)
    return tok0, kc, vc


@torch.no_grad()
def _dense_verify(dspec, params, toks, pos, kc, vc):
    """Greedy verification of C = K + 1 candidate positions per row
    against the dense cache (the static engine's verify; the paged one is
    inference/engine.py's). Row b writes candidate K/V at positions
    pos[b] + [0, C) in place and attends each candidate under a `kv_pos
    <= q_pos` mask. Returns the greedy argmax [B, C]."""
    b, c = toks.shape
    t = kc.shape[2]
    dev = toks.device
    qpos = pos[:, None] + torch.arange(c, device=dev)[None, :]   # [B, C]
    wp = torch.clamp(qpos, 0, t - 1)
    x = _embed(params, dspec, toks, qpos)                        # [B, C, H]
    cos, sin = _rope_at(params, dspec, qpos)                     # [B, C, 1, D]
    q_mask = torch.arange(t, device=dev)[None, None, :] <= qpos[:, :, None]
    rows = torch.arange(b, device=dev)[:, None]

    def attend(li, q, k, v):
        kcl, vcl = kc[li], vc[li]
        kcl[rows, wp] = k.to(kcl.dtype)
        vcl[rows, wp] = v.to(vcl.dtype)
        return _dense_attention(q, kcl, vcl, q_mask)

    for li, lw in enumerate(params["layers"]):
        x = _cached_block(x, lw, dspec, cos, sin,
                          functools.partial(attend, li))
    lg = _logits(x.reshape(b * c, -1), params, dspec)
    return lg.argmax(dim=-1).reshape(b, c)


def generate_static_spec(model, ids, max_new_tokens, eos_token_id=None,
                         k=None, max_ngram=3):
    """Greedy speculative decoding on the static engine: the n-gram
    proposer feeds a dense-cache verify, so `generate(engine="static",
    spec_decode="ngram")` emits several tokens per weight sweep without a
    serving engine. Token-identical to the non-speculative static engine
    ([B, max_new_tokens] int64, rows that finish early padded with eos).

    Every row rides every verify window: a row with no n-gram match
    proposes its last token repeated (auto-rejected, one token a window),
    and finished rows stop advancing."""
    from ..core.flags import flag

    dspec, params = _spec_and_params(model)
    k = int(k if k is not None else flag("FLAGS_spec_k"))
    if k < 1:
        raise ValueError(f"speculation depth k must be >= 1, got {k}")
    ids = np.asarray(ids, np.int64)
    if ids.ndim == 1:
        ids = ids[None]
    b, s = ids.shape
    mnt = int(max_new_tokens)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    max_pos = int(model.config.max_position_embeddings)
    if s + mnt > max_pos:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({mnt}) exceeds "
            f"max_position_embeddings ({max_pos})")
    bucket = min(max(default_buckets(s), s), max_pos)
    t_total = bucket + mnt + k + 1
    dev = params["embed"].device
    ids_p = np.zeros((b, bucket), np.int64)
    ids_p[:, :s] = ids
    tok0, kc, vc = _static_spec_prefill(
        dspec, t_total, params, torch.from_numpy(ids_p).to(dev), s)
    tok0 = tok0.cpu().numpy()
    out = [[int(tok0[i])] for i in range(b)]
    pos = np.full(b, s, np.int64)
    last = tok0.astype(np.int64)
    done = np.array([mnt <= 1 or (eos >= 0 and int(tok0[i]) == eos)
                     for i in range(b)])
    # every window advances every unfinished row by >= 1 token
    for _ in range(b * mnt + 2):
        if done.all():
            break
        toks = np.zeros((b, k + 1), np.int64)
        props = np.zeros((b, k), np.int64)
        for i in range(b):
            p = propose_ngram(
                np.concatenate([ids[i], np.asarray(out[i], np.int64)]),
                k, max_ngram)
            if p.size < k:
                p = np.concatenate(
                    [p, np.full(k - p.size, int(last[i]), np.int64)])
            props[i] = p
            toks[i, 0] = last[i]
            toks[i, 1:] = p
        g = _dense_verify(dspec, params, torch.from_numpy(toks).to(dev),
                          torch.from_numpy(pos).to(dev), kc, vc)
        g = g.cpu().numpy()
        for i in range(b):
            if done[i]:
                continue
            a = 0
            while a < k and props[i][a] == g[i, a]:
                a += 1
            new = [int(x) for x in props[i][:a]] + [int(g[i, a])]
            new = new[: mnt - len(out[i])]
            if eos >= 0:
                for j, tkn in enumerate(new):
                    if tkn == eos:
                        new = new[: j + 1]
                        break
            out[i].extend(new)
            pos[i] += len(new)
            last[i] = new[-1]
            if (eos >= 0 and new[-1] == eos) or len(out[i]) >= mnt:
                done[i] = True
    res = np.full((b, mnt), eos if eos >= 0 else 0, np.int64)
    for i in range(b):
        row = out[i][:mnt]
        res[i, :len(row)] = row
    return res
