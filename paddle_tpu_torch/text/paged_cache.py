"""Block-paged KV cache: the allocator and the cache-update rules.

Port of paddle_tpu/text/paged_cache.py: the pool in the model's dtype and
the quantized int8/int4 modes with per-(layer, block) scales (the prefix
cache, the chunk scatters and `gather_context` are not ported yet).

  * `BlockAllocator` — host-side free list over a fixed block pool. Block
    0 is the reserved TRASH block: every write whose destination must be
    masked out (padded prefill positions, padded decode slots) lands there,
    so release is copy-free (stale contents are never attended to: reads
    are bounded by per-sequence lengths, and appends overwrite a slot
    before a length ever exposes it).
  * `PagedKVCache` — the device tensors `[L, num_blocks, H_kv, block_size,
    D]` per k/v (int4: `block_size / 2` stored rows), plus `[L,
    num_blocks]` f32 scales in the quantized modes.
  * `append_token` / `scatter_prefill` — the decode append and the
    page-granular prefill scatter; `append_token_int8/int4` and
    `scatter_prefill_int8/int4` their quantized forms. Every quantized
    update dequantizes the whole touched block, inserts the new tokens,
    takes a new scale over the block's valid prefix and requantizes the
    whole block, exactly as the reference does.

Unlike the JAX reference, whose functions return new arrays, the update
functions here write into the pool and its scales IN PLACE
(`index_put_`), so the pool — the dominant device-memory tenant at
serving time — is never copied. They return what they updated.
"""
from __future__ import annotations

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


class PagedKVCache:
    """The pooled cache tensors for every layer of one model, zeroed at
    start (scales at 1e-8).

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
    validity mask [P_b, bs]."""
    l, s, hkv, d = ks.shape
    bs = int(block_size)
    p_b = s // bs
    tiles = ks.reshape(l, p_b, bs, hkv, d).transpose(2, 3)
    pos = torch.arange(p_b, device=ks.device)[:, None] * bs \
        + torch.arange(bs, device=ks.device)[None, :]
    page_valid = pos[:, 0] < int(true_len)
    dest = torch.where(page_valid, table_row[:p_b].to(ks.device).long(),
                       TRASH_BLOCK)
    return tiles, dest, pos < int(true_len)


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
