"""Block-paged KV cache: the allocator, the prefix cache and the
cache-update rules.

Port of paddle_tpu/text/paged_cache.py: the pool in the model's dtype and
the quantized int8/int4 modes with per-(layer, block) scales.

  * `BlockAllocator` — host-side free list over a fixed block pool. Block
    0 is the reserved TRASH block: every write whose destination must be
    masked out (padded prefill positions, padded decode slots, chunk
    positions past the prompt) lands there, so release is copy-free
    (stale contents are never attended to: reads are bounded by
    per-sequence lengths or the chunk's causal mask, and appends
    overwrite a slot before a length ever exposes it).
  * `hash_blocks` / `PrefixCache` — chained sha256 content hashes of full
    blocks, and the hash->block map with per-block refcounts and an LRU
    of refcount-0 cached blocks over the allocator. A request whose
    prompt shares a cached prefix points its table at the cached blocks;
    release parks hash-mapped blocks in the LRU, and allocation under
    pressure evicts from it, never a block something still references.
  * `PagedKVCache` — the device tensors `[L, num_blocks, H_kv, block_size,
    D]` per k/v (int4: `block_size / 2` stored rows), plus `[L,
    num_blocks]` f32 scales in the quantized modes.
  * `append_token` / `scatter_prefill` — the decode append and the
    page-granular prefill scatter; `append_token_int8/int4` and
    `scatter_prefill_int8/int4` their quantized forms. Every quantized
    update dequantizes the whole touched block, inserts the new tokens,
    takes a new scale over the block's valid prefix and requantizes the
    whole block, exactly as the reference does.
  * `scatter_chunk` (+ `_int8` / `_int4`) / `gather_context` — the chunked
    prefill's token-granular scatter (a chunk may start mid-block) and the
    gather of one layer's context pages for the chunk's attention.

Unlike the JAX reference, whose functions return new arrays, the update
functions here write into the pool and its scales IN PLACE
(`index_put_`), so the pool — the dominant device-memory tenant at
serving time — is never copied. They return what they updated. Where
JAX clamps an out-of-range index or drops an update (`mode="drop"`),
torch raises, so every clamp and drop is written out.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from ..ops.quantized import INT4_QMAX, int4_pack, int4_unpack

#: block id 0 is never allocated — masked writes land there
TRASH_BLOCK = 0


class BlockAllocator:
    """Free-list allocator over `num_blocks` cache blocks (block 0 reserved
    as trash). Allocation is all-or-nothing: a request either gets its
    full block budget up front (admission control) or stays queued."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash block)")
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, 0, -1))  # pop() -> 1..

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """n block ids, or None when the pool can't cover them."""
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, ids) -> None:
        for b in ids:
            b = int(b)
            if not 0 < b < self.num_blocks:
                raise ValueError(f"freeing invalid block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold `tokens` cache entries."""
    return -(-int(tokens) // int(block_size))


# ------------------------------------------------------- prefix caching

def hash_blocks(tokens, block_size: int, namespace: int = 0) -> list:
    """Chained content hashes of every FULL block of `tokens`: block i's
    sha256 digest covers its own token ids and, through the chain, every
    token before it, so equal hashes mean equal whole prefixes.
    `namespace` seeds the chain (KV content depends on the model and the
    cache mode). The same bytes as the reference's, so the two produce
    equal digests."""
    bs = int(block_size)
    toks = np.asarray(tokens).reshape(-1).astype(np.int64)
    h = hashlib.sha256(
        b"paddle_tpu.prefix_cache:%d" % int(namespace)).digest()
    out = []
    for i in range(len(toks) // bs):
        h = hashlib.sha256(h + toks[i * bs:(i + 1) * bs].tobytes()).digest()
        out.append(h)
    return out


class PrefixCache:
    """Hash->block map + per-block refcounts + LRU over a BlockAllocator.

    `allocate` hands out private blocks at refcount 1 (evicting refcount-0
    cached blocks when the free list runs dry); `register` publishes a
    computed full block under its content hash; `lookup` serves a new
    request's shared prefix by bumping refcounts; `release` decrefs — a
    hash-mapped block at refcount 0 parks in the LRU (its KV stays warm)
    while an unmapped block goes back to the free list. Only refcount-0
    blocks are ever evicted. Host-side and single-owner, like the engine
    that drives it."""

    def __init__(self, allocator: BlockAllocator, max_cached_blocks: int = 0):
        self.allocator = allocator
        #: cap on refcount-0 cached blocks (0 = bounded only by the pool)
        self.max_cached_blocks = int(max_cached_blocks)
        self._map: dict = {}          # hash -> block id (full blocks only)
        self._block_hash: dict = {}   # block id -> hash (inverse)
        self._ref: dict = {}          # block id -> refcount (live blocks)
        self._lru: OrderedDict = OrderedDict()  # refcount-0 cached blocks
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def cached_blocks(self) -> int:
        """Blocks currently addressable by content hash."""
        return len(self._map)

    @property
    def referenced_blocks(self) -> int:
        """Hash-mapped blocks some live request still references (the
        mapped refcount-0 blocks are exactly the LRU's members)."""
        return len(self._map) - len(self._lru)

    @property
    def evictable(self) -> int:
        return len(self._lru)

    @property
    def available(self) -> int:
        """Blocks an admission could obtain: free list + evictable LRU."""
        return self.allocator.available + len(self._lru)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    def allocate(self, n: int):
        """All-or-nothing like BlockAllocator.alloc, but refcount-0 cached
        blocks count as capacity: LRU blocks are evicted (hash entries
        dropped) to make room. Returns private block ids at refcount 1, or
        None."""
        n = int(n)
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if n > self.available:
            return None
        while self.allocator.available < n:
            self._evict_one()
        ids = self.allocator.alloc(n)
        for b in ids:
            self._ref[b] = 1
        return ids

    def _evict_one(self):
        blk, _ = self._lru.popitem(last=False)      # least recently used
        h = self._block_hash.pop(blk)
        del self._map[h]
        self._ref.pop(blk, None)
        self.allocator.free([blk])
        self.evictions += 1

    def lookup(self, hashes) -> list:
        """Longest cached prefix of `hashes`, consecutive from block 0.
        Found blocks get a refcount bump (and leave the LRU). Counts hits
        for the found run and misses for the remainder."""
        found = []
        for h in hashes:
            blk = self._map.get(h)
            if blk is None:
                break
            self.ref(blk)
            found.append(blk)
        self.hits += len(found)
        self.misses += len(hashes) - len(found)
        return found

    def ref(self, block_id: int) -> None:
        blk = int(block_id)
        self._ref[blk] = self._ref.get(blk, 0) + 1
        self._lru.pop(blk, None)

    def cancel_lookup(self, found, n_hashes: int) -> None:
        """Undo a lookup whose admission could not proceed (pool full):
        release its refs and roll the hit/miss counters back."""
        self.hits -= len(found)
        self.misses -= int(n_hashes) - len(found)
        self.release(found)

    def register(self, hashes, block_ids) -> None:
        """Publish computed full blocks under their content hashes (zip of
        parallel lists). A hash already mapped to another block keeps its
        mapping (the newer copy stays private and free-lists on release);
        a block registered under another hash is rekeyed. Idempotent."""
        for h, blk in zip(hashes, block_ids):
            blk = int(blk)
            if h in self._map:
                continue
            old_h = self._block_hash.get(blk)
            if old_h is not None and old_h != h:
                del self._map[old_h]
            self._map[h] = blk
            self._block_hash[blk] = h

    def release(self, block_ids) -> None:
        """Decref each block; at refcount 0 a hash-mapped block parks in
        the LRU and an unmapped block free-lists. Releasing a block at
        refcount 0 raises."""
        for blk in block_ids:
            blk = int(blk)
            refs = self._ref.get(blk, 0)
            if refs <= 0:
                raise ValueError(f"release of unreferenced block {blk}")
            if refs > 1:
                self._ref[blk] = refs - 1
                continue
            del self._ref[blk]
            if blk in self._block_hash:
                self._lru[blk] = None
                self._lru.move_to_end(blk)
                self._trim()
            else:
                self.allocator.free([blk])

    def _trim(self):
        if self.max_cached_blocks <= 0:
            return
        while len(self._lru) > self.max_cached_blocks:
            self._evict_one()


class PagedKVCache:
    """The pooled cache tensors for every layer of one model, zeroed at
    start (scales at 1e-8). The chunk program's attention relies on the
    zero fill: it gathers whole context pages, stale or never written
    past the prompt's watermark, and the causal mask keeps them out of
    the scores, but `probs @ V` still multiplies their 0 probabilities by
    what they hold, and 0 x NaN would be NaN.

    dtype: a torch dtype (the model's: k/v stored directly) or the mode
    "int8" (int8 codes plus one f32 scale per (layer, block)) or "int4"
    (the same, two tokens per byte along the block_size axis: byte t holds
    token t in its low nibble and token bs/2 + t in its high nibble)."""

    def __init__(self, num_layers: int, num_blocks: int, num_kv_heads: int,
                 block_size: int, head_dim: int, dtype, device):
        if int(block_size) % 8:
            raise ValueError(
                f"kv block_size {block_size} must be a multiple of 8")
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.num_kv_heads = int(num_kv_heads)
        self.block_size = int(block_size)
        self.head_dim = int(head_dim)
        #: "model" | "int8" | "int4": int4 stores int8 tensors too, so the
        #: mode, not the tensor dtype, is what callers key on
        self.mode = str(dtype) if str(dtype) in ("int8", "int4") \
            else "model"
        self.quantized = self.mode != "model"
        self.dtype = torch.int8 if self.quantized else dtype
        self.stored_block_size = self.block_size // 2 \
            if self.mode == "int4" else self.block_size
        shape = (self.num_layers, self.num_blocks, self.num_kv_heads,
                 self.stored_block_size, self.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=device)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.full((self.num_layers, self.num_blocks),
                                      1e-8, dtype=torch.float32,
                                      device=device)
            self.v_scale = torch.full_like(self.k_scale, 1e-8)

    @property
    def hbm_bytes(self) -> int:
        """Device bytes of the pool: k and v, plus the scales."""
        per = self.k.numel() * self.k.element_size()
        scales = 0 if self.k_scale is None else 2 * self.k_scale.numel() * 4
        return 2 * per + scales


def append_token(cache, kv, block_ids, offsets):
    """Write one token per slot in place: kv [B, H_kv, D] at
    (block_ids[b], :, offsets[b]) of one layer's cache [N, H_kv, bs, D].
    Padded slots route to the trash block; duplicate trash writes are
    harmless. Returns `cache`."""
    cache[block_ids.long(), :, offsets.long()] = kv.to(cache.dtype)
    return cache


def _insert_and_rescale(x, kv, off, qmax):
    """The shared step of the quantized appends: x [B, H_kv, bs, D] holds
    the touched blocks dequantized (f32); write each row's new token kv
    [B, H_kv, D] at its offset, in place, and return the new per-block
    scales [B] over the VALID prefix (slots <= offset — stale tail entries
    never pollute them)."""
    b, bs = x.shape[0], x.shape[2]
    x[torch.arange(b, device=x.device), :, off] = kv.float()
    valid = torch.arange(bs, device=x.device)[None, :] <= off[:, None]
    amax = (x.abs() * valid[:, None, :, None]).amax(dim=(1, 2, 3))
    return torch.clamp_min(amax / qmax, 1e-8)


def append_token_int8(cache, scale, kv, block_ids, offsets):
    """Int8 append with per-block requantization, in place: the touched
    block is dequantized against its current scale, the new token
    inserted, a new scale taken over the valid prefix, and the whole block
    requantized. cache [N, H_kv, bs, D] int8; scale [N] f32. Returns
    (cache, scale)."""
    blk, off = block_ids.long(), offsets.long()
    x = cache[blk].float() * scale[blk][:, None, None, None]
    new_scale = _insert_and_rescale(x, kv, off, 127.0)
    cache[blk] = torch.clamp(torch.round(x / new_scale[:, None, None, None]),
                             -127, 127).to(torch.int8)
    scale[blk] = new_scale
    return cache, scale


def _prefill_pages(ks, true_len, table_row, block_size):
    """Prefill-scatter prep: ks [L, S, H_kv, D] (S a multiple of
    block_size) -> per-page tiles [L, P_b, H_kv, bs, D], destination
    block ids [P_b] (pages at or past `true_len` -> trash) and a per-token
    validity mask [P_b, bs]. `true_len` is an int or a 0-dim tensor (a
    serving program's static input), compared on the device, never read
    back."""
    l, s, hkv, d = ks.shape
    bs = int(block_size)
    p_b = s // bs
    tiles = ks.reshape(l, p_b, bs, hkv, d).transpose(2, 3)
    pos = torch.arange(p_b, device=ks.device)[:, None] * bs \
        + torch.arange(bs, device=ks.device)[None, :]
    tok_valid = pos < true_len
    dest = torch.where(tok_valid[:, 0], table_row[:p_b].to(ks.device).long(),
                       TRASH_BLOCK)
    return tiles, dest, tok_valid


def scatter_prefill(cache, ks, true_len, table_row, block_size):
    """Write a whole prompt's K (or V) into its pages, in place, in one
    scatter. cache [L, N, H_kv, bs, D]; ks [L, S, H_kv, D]; positions >=
    true_len land in the trash block. Returns `cache`."""
    tiles, dest, _ = _prefill_pages(ks, true_len, table_row, block_size)
    cache[:, dest] = tiles.to(cache.dtype)
    return cache


def _page_scales(tf, tok_valid, qmax):
    """One scale per (layer, page) over the page's valid tokens:
    tf [L, P_b, H_kv, bs, D] f32 -> [L, P_b]."""
    amax = (tf.abs() * tok_valid[None, :, None, :, None]).amax(
        dim=(2, 3, 4))
    return torch.clamp_min(amax / qmax, 1e-8)


def scatter_prefill_int8(cache, scale, ks, true_len, table_row,
                         block_size):
    """Int8 prefill scatter, in place: one scale per (layer, page) over
    the page's valid tokens, whole-page requantized write. cache [L, N,
    H_kv, bs, D] int8; scale [L, N] f32. Returns (cache, scale)."""
    tiles, dest, tok_valid = _prefill_pages(ks, true_len, table_row,
                                            block_size)
    tf = tiles.float()
    new_scale = _page_scales(tf, tok_valid, 127.0)
    cache[:, dest] = torch.clamp(
        torch.round(tf / new_scale[:, :, None, None, None]), -127,
        127).to(torch.int8)
    scale[:, dest] = new_scale
    return cache, scale


# -------------------------------------------------------- int4-KV updates
# Same contracts as the int8 forms, with the block's tokens stored two per
# byte along the block_size axis. Every update dequantizes (unpack + scale)
# the touched block, edits it at full block_size resolution, requantizes
# over the valid prefix against the -7..7 range and repacks, so a block's
# scale always covers exactly its valid tokens.

def _unpack_block(packed, bs):
    """[..., bs/2, D] packed int8 -> [..., bs, D] int4 values (int8)."""
    return int4_unpack(packed, bs, axis=-2)


def _requant_pack_int4(x, new_scale, lead_dims):
    """Quantize a dequantized block tensor x [..., bs, D] against
    per-block scales (broadcast over `lead_dims` leading axes) and repack
    to [..., bs/2, D] int8."""
    s = new_scale.reshape(new_scale.shape + (1,) * (x.dim() - lead_dims))
    q = torch.clamp(torch.round(x / s), -INT4_QMAX, INT4_QMAX)
    return int4_pack(q.to(torch.int8), axis=-2)


def append_token_int4(cache, scale, kv, block_ids, offsets):
    """Int4 decode append, in place: dequantize (unpack + scale) the
    touched block, insert the new token, rescale over the valid prefix,
    requantize and repack. cache [N, H_kv, bs/2, D] int8-packed; scale [N]
    f32. Returns (cache, scale)."""
    blk, off = block_ids.long(), offsets.long()
    x = _unpack_block(cache[blk], cache.shape[2] * 2).float() \
        * scale[blk][:, None, None, None]                     # [B, Hkv, bs, D]
    new_scale = _insert_and_rescale(x, kv, off, INT4_QMAX)
    cache[blk] = _requant_pack_int4(x, new_scale, 1)
    scale[blk] = new_scale
    return cache, scale


def scatter_prefill_int4(cache, scale, ks, true_len, table_row,
                         block_size):
    """Int4 prefill scatter, in place: one scale per (layer, page) over
    the page's valid tokens, whole-page requantized and packed write.
    cache [L, N, H_kv, bs/2, D] int8-packed; scale [L, N] f32. Returns
    (cache, scale)."""
    tiles, dest, tok_valid = _prefill_pages(ks, true_len, table_row,
                                            block_size)
    tf = tiles.float()
    new_scale = _page_scales(tf, tok_valid, INT4_QMAX)
    cache[:, dest] = _requant_pack_int4(tf, new_scale, 2)
    scale[:, dest] = new_scale
    return cache, scale


# ------------------------------------------------ chunked-prefill updates
# One LAYER's cache slice, like the decode appends. The chunk's first
# position need not be page-aligned (a prefix-cache hit can start a suffix
# mid-block after copy-on-write), so the scatter is token-granular:
# position p lands at (table_row[p // bs], p % bs). start and true_end are
# ints or 0-dim tensors.

def scatter_chunk(cache, ks, start, true_end, table_row, block_size):
    """Write one chunk's K (or V) through the block table, in place. ks
    [C, H_kv, D] holds positions [start, start + C); positions >=
    true_end route to the trash block (duplicate trash writes are
    harmless: it is never read; a real (block, offset) appears once).
    cache is one layer's [num_blocks, H_kv, bs, D]. Returns `cache`."""
    c = ks.shape[0]
    pos = start + torch.arange(c, device=ks.device)
    page = torch.clamp(pos // block_size, 0, table_row.shape[0] - 1)
    blk = torch.where(pos < true_end, table_row[page].long(), TRASH_BLOCK)
    cache[blk, :, pos % block_size] = ks.to(cache.dtype)
    return cache


def _chunk_window(c, start, true_end, table_row, bs, device):
    """The pages a C-token chunk from `start` can touch — ceil(C/bs) + 1
    (a chunk starting mid-block spills into one more) — as destination
    blocks [P_t] (pages past true_end or the table -> trash), each token's
    page in the window [C] (P_t for tokens past true_end: the scratch
    page, dropped), its offset [C], and the pages' valid-token mask
    [P_t, bs] (positions < true_end)."""
    p_t = -(-c // bs) + 1
    n_pages = table_row.shape[0]
    page0 = start // bs
    pages = page0 + torch.arange(p_t, device=device)
    page_ok = (pages * bs < true_end) & (pages < n_pages)
    dest = torch.where(page_ok,
                       table_row[torch.clamp(pages, 0, n_pages - 1)].long(),
                       TRASH_BLOCK)
    pos = start + torch.arange(c, device=device)
    tok_page = torch.where(pos < true_end, pos // bs - page0, p_t)
    valid = (pages[:, None] * bs
             + torch.arange(bs, device=device)[None, :]) < true_end
    return dest, tok_page, pos % bs, valid


def _insert_chunk(x, ks, tok_page, off):
    """x [P_t, H_kv, bs, D] f32 (the window's pages, dequantized) with the
    chunk's tokens written at (tok_page, :, off). Tokens whose tok_page is
    P_t land on a scratch page that is then cut off: the reference's
    `mode="drop"`, which index_put_ does not have."""
    buf = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    buf[tok_page, :, off] = ks.float()
    return buf[:x.shape[0]]


def _window_scales(x, valid, qmax):
    """One scale per window page over its valid tokens: [P_t]."""
    amax = (x.abs() * valid[:, None, :, None]).amax(dim=(1, 2, 3))
    return torch.clamp_min(amax / qmax, 1e-8)


def scatter_chunk_int8(cache, scale, ks, start, true_end, table_row,
                       block_size):
    """Int8 chunk scatter, in place: every page the chunk touches is
    dequantized against its current scale (pre-existing content — earlier
    chunks, a copy-on-write prefix — survives), the chunk's tokens
    inserted, and the page requantized over its valid prefix (positions <
    true_end). cache [N, H_kv, bs, D] int8; scale [N] f32. Returns
    (cache, scale)."""
    bs = int(block_size)
    dest, tok_page, off, valid = _chunk_window(ks.shape[0], start, true_end,
                                               table_row, bs, ks.device)
    x = cache[dest].float() * scale[dest][:, None, None, None]
    x = _insert_chunk(x, ks, tok_page, off)
    new_scale = _window_scales(x, valid, 127.0)
    cache[dest] = torch.clamp(torch.round(x / new_scale[:, None, None, None]),
                              -127, 127).to(torch.int8)
    scale[dest] = new_scale
    return cache, scale


def scatter_chunk_int4(cache, scale, ks, start, true_end, table_row,
                       block_size):
    """Int4 chunk scatter, in place: as `scatter_chunk_int8`, with each
    page unpacked before and repacked after (-7..7 range). cache [N, H_kv,
    bs/2, D] int8-packed; scale [N] f32. Returns (cache, scale)."""
    bs = int(block_size)
    dest, tok_page, off, valid = _chunk_window(ks.shape[0], start, true_end,
                                               table_row, bs, ks.device)
    x = _unpack_block(cache[dest], bs).float() \
        * scale[dest][:, None, None, None]
    x = _insert_chunk(x, ks, tok_page, off)
    new_scale = _window_scales(x, valid, INT4_QMAX)
    cache[dest] = _requant_pack_int4(x, new_scale, 1)
    scale[dest] = new_scale
    return cache, scale


def gather_context(cache, scale, table_row, ctx_pages, int4=False):
    """One layer's context K (or V) for the chunk's attention: the first
    `ctx_pages` table entries gathered to [ctx_pages * bs, H_kv, D]
    (dequantized to f32 when `scale` is given; `int4=True` unpacks the
    token axis first). Pages past the written watermark surface stale or
    zero content that the caller's `kv_pos <= q_pos` mask never
    attends."""
    idx = table_row[:ctx_pages].long()
    tiles = cache[idx]                         # [P, H_kv, bs(/2), D]
    if int4:
        tiles = _unpack_block(tiles, tiles.shape[2] * 2)
    if scale is not None:
        tiles = tiles.float() * scale[idx][:, None, None, None]
    p, hkv, bs, d = tiles.shape
    return tiles.transpose(1, 2).reshape(p * bs, hkv, d)
