"""Block-paged KV cache: the allocator and the cache-update rules.

Port of paddle_tpu/text/paged_cache.py for caches in the model's dtype
(the int8/int4 modes and the prefix cache are not ported yet).

  * `BlockAllocator` — host-side free list over a fixed block pool. Block
    0 is the reserved TRASH block: every write whose destination must be
    masked out (padded prefill positions, padded decode slots) lands there,
    so release is copy-free (stale contents are never attended to: reads
    are bounded by per-sequence lengths, and appends overwrite a slot
    before a length ever exposes it).
  * `PagedKVCache` — the device tensors `[L, num_blocks, H_kv, block_size,
    D]` per k/v.
  * `append_token` / `scatter_prefill` — the decode append and the
    page-granular prefill scatter.

Unlike the JAX reference, whose functions return new arrays, the update
functions here write into the pool IN PLACE (`index_put_`), so the pool —
the dominant device-memory tenant at serving time — is never copied.
"""
from __future__ import annotations

import torch

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


class PagedKVCache:
    """The pooled cache tensors for every layer of one model, zeroed at
    start. `dtype` is a torch dtype (the model's); the quantized modes
    "int8"/"int4" are not ported yet."""

    def __init__(self, num_layers: int, num_blocks: int, num_kv_heads: int,
                 block_size: int, head_dim: int, dtype, device):
        if str(dtype) in ("int8", "int4"):
            raise NotImplementedError(
                f"{dtype} KV cache is not ported yet (ROADMAP Queue 1, "
                "item 3, 'Quantized serving')")
        if int(block_size) % 8:
            raise ValueError(
                f"kv block_size {block_size} must be a multiple of 8")
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.num_kv_heads = int(num_kv_heads)
        self.block_size = int(block_size)
        self.head_dim = int(head_dim)
        shape = (self.num_layers, self.num_blocks, self.num_kv_heads,
                 self.block_size, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)


def append_token(cache, kv, block_ids, offsets):
    """Write one token per slot in place: kv [B, H_kv, D] at
    (block_ids[b], :, offsets[b]) of one layer's cache [N, H_kv, bs, D].
    Padded slots route to the trash block; duplicate trash writes are
    harmless. Returns `cache`."""
    cache[block_ids.long(), :, offsets.long()] = kv.to(cache.dtype)
    return cache


def _prefill_pages(ks, true_len, table_row, block_size):
    """Prefill-scatter prep: ks [L, S, H_kv, D] (S a multiple of
    block_size) -> per-page tiles [L, P_b, H_kv, bs, D] and destination
    block ids [P_b] (pages at or past `true_len` -> trash)."""
    l, s, hkv, d = ks.shape
    bs = int(block_size)
    p_b = s // bs
    tiles = ks.reshape(l, p_b, bs, hkv, d).transpose(2, 3)
    page_valid = torch.arange(p_b, device=ks.device) * bs < int(true_len)
    dest = torch.where(page_valid, table_row[:p_b].to(ks.device).long(),
                       TRASH_BLOCK)
    return tiles, dest


def scatter_prefill(cache, ks, true_len, table_row, block_size):
    """Write a whole prompt's K (or V) into its pages, in place, in one
    scatter. cache [L, N, H_kv, bs, D]; ks [L, S, H_kv, D]; positions >=
    true_len land in the trash block. Returns `cache`."""
    tiles, dest = _prefill_pages(ks, true_len, table_row, block_size)
    cache[:, dest] = tiles.to(cache.dtype)
    return cache
