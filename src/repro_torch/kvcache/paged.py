"""Paged KV cache (counterpart of ``repro.kvcache.paged``).

Physical KV blocks live in one pool tensor per K and V, and a
per-request table of block ids maps logical to physical positions.
Allocation is at block granularity from a free list, with admission
control by a free-block watermark (:class:`BlockManager`, a copy of the
reference's).

:class:`PagedKVCache` holds the pool as ``{"k", "v"}``, each
``[L, NB+1, BS, K, hd]`` in the model's dtype on its device. Block ``NB``
is the *trash* block: batch-padding rows write there, so the engine can
pad the running batch to power-of-two buckets without touching live
state. Writes are **in place** (``index_copy_`` / ``index_put_``) where
the reference rebuilds donated buffers. Decode reads the pool either
through a :class:`PagedCacheView` (zero-copy) or, in the gather
fallback, through a dense copy (:meth:`PagedKVCache.gather`) whose new
rows :meth:`PagedKVCache.scatter_new_token` writes back.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kvcache.view import PagedCacheView


class BlockManager:
    """Ref-counted free-list block allocator with a vLLM-style watermark.

    Physical blocks carry a reference count so they can be *shared* across
    requests (the prefix cache splices one block into many tables):
    :meth:`allocate` hands out fresh blocks with one reference,
    :meth:`share` splices existing blocks into another request's table
    (+1 each), and the prefix index pins cached blocks with its own
    reference via :meth:`incref`/:meth:`decref`. A block returns to the
    free list only when its last reference drops.

    :meth:`allocate` enforces the same watermark :meth:`can_allocate`
    advertises: the last ``watermark_blocks`` blocks are a preemption
    reserve, reachable only with ``allow_reserve=True`` — the engine's
    mid-decode append/COW path, which is backed by preempt-on-exhaustion.
    (Previously ``allocate`` only checked raw exhaustion, so the
    ``append_token`` path could silently drain the reserve that admission
    control was counting on.)
    """

    def __init__(self, num_blocks: int, block_size: int,
                 watermark: float = 0.01):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: List[int] = list(range(num_blocks))
        self.tables: Dict[int, List[int]] = {}
        self.refs: Dict[int, int] = {}           # live block -> ref count
        self.watermark_blocks = max(1, int(num_blocks * watermark))
        # bumped on every table mutation; lets the pool cache device-side
        # block tables and only re-upload when something actually changed
        self.version = 0
        self.total_allocations = 0   # fresh blocks handed out (telemetry)
        self.cow_copies = 0          # copy-on-write forks (telemetry)

    @property
    def free_blocks(self) -> int:
        """Blocks on the free list (including the watermark reserve)."""
        return len(self.free)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return (len(self.free) - self.blocks_needed(n_tokens)
                >= self.watermark_blocks)

    def allocate(self, req_id: int, n_tokens: int, *,
                 allow_reserve: bool = False) -> List[int]:
        need = self.blocks_needed(n_tokens)
        if need > len(self.free):
            raise RuntimeError("KV pool exhausted")
        if not allow_reserve and len(self.free) - need < self.watermark_blocks:
            raise RuntimeError(
                f"allocation of {need} blocks would drain the watermark "
                f"reserve ({len(self.free)} free, {self.watermark_blocks} "
                f"reserved); check can_allocate first or pass "
                f"allow_reserve=True for the in-flight decode path")
        got = [self.free.pop() for _ in range(need)]
        for b in got:
            self.refs[b] = 1
        self.total_allocations += need
        self.tables.setdefault(req_id, []).extend(got)
        self.version += 1
        return got

    def covered_tokens(self, req_id: int) -> int:
        """Tokens the request's current table can hold (block-granular)."""
        return len(self.tables.get(req_id, ())) * self.block_size

    def can_extend(self, req_id: int, target_tokens: int) -> bool:
        """Could the table grow to cover ``target_tokens`` without
        draining the watermark reserve? (True when it already does.)"""
        short = target_tokens - self.covered_tokens(req_id)
        return short <= 0 or self.can_allocate(short)

    def extend(self, req_id: int, target_tokens: int, *,
               allow_reserve: bool = False) -> List[int]:
        """Grow ``req_id``'s table to cover ``target_tokens`` total tokens.

        The chunked-prefill allocation entry point: each prompt chunk
        extends the table by exactly the blocks it is about to write, so a
        long prompt streams into the pool across steps instead of
        reserving its whole footprint at admission. Enforces the same
        admission watermark as :meth:`allocate` (a chunk must never
        over-allocate past the reserve); returns the new blocks (empty
        when the table already covers the target).
        """
        short = target_tokens - self.covered_tokens(req_id)
        if short <= 0:
            return []
        return self.allocate(req_id, short, allow_reserve=allow_reserve)

    def share(self, req_id: int, blocks: Sequence[int]):
        """Splice existing (cached) blocks into ``req_id``'s table.

        The caller appends them *before* allocating any private suffix
        blocks so logical order is preserved. Each shared block gains one
        reference; the request's :meth:`release` drops it again.
        """
        for b in blocks:
            self.refs[b] += 1
        self.tables.setdefault(req_id, []).extend(blocks)
        self.version += 1

    def incref(self, block: int):
        """Pin a live block (prefix-cache reference, not tied to a table)."""
        self.refs[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        n = self.refs[block] - 1
        if n > 0:
            self.refs[block] = n
            return False
        del self.refs[block]
        self.free.append(block)
        return True

    def ref_count(self, block: int) -> int:
        return self.refs.get(block, 0)

    def needs_block(self, req_id: int, new_len: int) -> bool:
        """Would extending req_id to new_len tokens require a new block?"""
        return new_len > len(self.tables.get(req_id, ())) * self.block_size

    def needs_cow(self, req_id: int, pos: int) -> bool:
        """Would writing at ``pos`` hit a block shared with other owners?"""
        table = self.tables.get(req_id, ())
        idx = pos // self.block_size
        return idx < len(table) and self.refs.get(table[idx], 0) > 1

    def append_token(self, req_id: int, new_len: int) -> Optional[int]:
        """Ensure capacity for new_len tokens; returns a new block or None.

        May dip into the watermark reserve: a running request must be able
        to take its next token (that is what the reserve is *for*); the
        engine preempts when even the reserve is gone.
        """
        if self.needs_block(req_id, new_len):
            have = len(self.tables.get(req_id, ())) * self.block_size
            return self.allocate(req_id, new_len - have,
                                 allow_reserve=True)[0]
        return None

    def copy_on_write(self, req_id: int,
                      block_idx: int) -> Optional[Tuple[int, int]]:
        """Fork a shared block so ``req_id`` can write into it.

        Returns ``(old, new)`` physical ids when a fork happened (the
        caller must copy the pool contents), or None when the block is
        already private. The fresh block may come from the watermark
        reserve — an in-flight request's write, like ``append_token``.
        """
        table = self.tables[req_id]
        old = table[block_idx]
        if self.refs[old] <= 1:
            return None
        if not self.free:
            raise RuntimeError("KV pool exhausted (copy-on-write)")
        new = self.free.pop()
        self.refs[new] = 1
        self.refs[old] -= 1
        self.total_allocations += 1
        self.cow_copies += 1
        table[block_idx] = new
        self.version += 1
        return old, new

    def truncate(self, req_id: int, keep_blocks: int) -> List[int]:
        """Drop ``req_id``'s table blocks beyond the first ``keep_blocks``.

        The token-granular rollback primitive (speculative decoding
        releases rejected-token KV through it): tail blocks leave the
        table and drop one reference each — a block returns to the free
        list only when no other owner (another request's table or the
        prefix index) still holds it, so prefix-shared blocks are never
        reclaimed out from under their co-owners. Returns the dropped
        physical ids (possibly still live via other references).
        """
        if keep_blocks < 0:
            raise ValueError(f"keep_blocks must be >= 0, got {keep_blocks}")
        table = self.tables.get(req_id)
        if table is None or keep_blocks >= len(table):
            return []
        dropped = table[keep_blocks:]
        del table[keep_blocks:]
        for b in dropped:
            self.decref(b)
        self.version += 1
        return dropped

    def release(self, req_id: int):
        table = self.tables.pop(req_id, [])
        for b in table:
            self.decref(b)
        if table:
            self.version += 1

    @property
    def used_fraction(self) -> float:
        return 1.0 - len(self.free) / self.num_blocks


class PagedKVCache:
    """Physical paged pool for a dense decoder's attention K/V."""

    def __init__(self, cfg: ArchConfig, *, num_blocks: int, block_size: int,
                 device: torch.device):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.device = torch.device(device)
        self.manager = BlockManager(num_blocks, block_size)
        self.trash_block = num_blocks          # physical block for padding
        shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads,
                 cfg.hd)
        self.pool: Dict[str, torch.Tensor] = {
            name: torch.zeros(shape, dtype=cfg.activation_dtype,
                              device=self.device) for name in ("k", "v")}
        # one physical block's bytes summed over every paged leaf (the
        # reference's accounting, integer-equal to it)
        self.block_bytes: int = sum(
            t.numel() * t.element_size() // (num_blocks + 1)
            for t in self.pool.values())

    @property
    def pool_bytes(self) -> int:
        """Accountable pool bytes: every real physical block (the trash
        block never holds request state and is excluded)."""
        return self.block_bytes * self.num_blocks

    @property
    def token_bytes(self) -> float:
        """KV bytes one written token occupies (block_bytes/block_size)."""
        return self.block_bytes / self.block_size

    def write_prefill(self, req_id: int, cache_one: Dict[str, torch.Tensor]):
        """Store one request's prefill K/V (``[L, 1, S, K, hd]`` leaves)
        into its allocated blocks, in place. Rows past the table's capacity
        are dropped; a partly covered last block is zero-padded."""
        blocks = self.manager.tables[req_id]
        nb = len(blocks)
        S_cap = nb * self.block_size
        phys = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for name, leaf in self.pool.items():
            v = cache_one[name][:, 0, :S_cap]                  # [L,S,K,hd]
            if v.shape[1] < S_cap:
                v = torch.nn.functional.pad(
                    v, (0, 0, 0, 0, 0, S_cap - v.shape[1]))
            v = v.reshape(v.shape[0], nb, self.block_size, *v.shape[2:])
            leaf.index_copy_(1, phys, v.to(leaf.dtype))

    def view(self, req_ids: Sequence[int], positions: Sequence[int],
             nb_pad: int, batch_pad: int) -> PagedCacheView:
        """Zero-copy :class:`PagedCacheView` over the pool for ``req_ids``.

        ``positions[i]`` is the write position of request i's new token.
        ``nb_pad``/``batch_pad`` are the bucketed table width and batch
        size; rows past ``len(req_ids)`` are padding: a table row of trash
        blocks, position 0 and length 0. (The reference lets padding rows
        drift to small nonzero positions, which its clamped gathers
        tolerate; here every padding row is rebuilt each step so that its
        write address ``tables[i, 0]`` is always in range.)
        """
        B = len(req_ids)
        if B > batch_pad:
            raise ValueError(f"{B} requests exceed batch_pad={batch_pad}")
        # table, lengths and positions in one buffer: one upload a step
        n_tab = batch_pad * nb_pad
        buf = np.zeros((n_tab + 2 * batch_pad,), np.int32)
        table = buf[:n_tab].reshape(batch_pad, nb_pad)
        lens = buf[n_tab:n_tab + batch_pad]
        pos = buf[n_tab + batch_pad:]
        table[:] = self.trash_block
        for i, rid in enumerate(req_ids):
            blocks = self.manager.tables.get(rid, [])[:nb_pad]
            table[i, :len(blocks)] = blocks
        pos[:B] = positions
        lens[:B] = pos[:B] + 1
        dev = torch.from_numpy(buf).to(self.device)
        return PagedCacheView(
            self.pool, dev[:n_tab].view(batch_pad, nb_pad),
            dev[n_tab:n_tab + batch_pad], dev[n_tab + batch_pad:],
            self.block_size)

    def gather(self, req_ids: Sequence[int],
               pad_blocks: int) -> Dict[str, torch.Tensor]:
        """A dense copy of the requests' caches (the gather fallback):
        ``{"k", "v"}``, each ``[L, B, pad_blocks * BS, K, hd]``. Slots past
        a request's allocation read the trash block; the decode step's
        lengths mask them."""
        table = np.full((len(req_ids), pad_blocks), self.trash_block,
                        np.int64)
        for i, rid in enumerate(req_ids):
            blocks = self.manager.tables.get(rid, [])[:pad_blocks]
            table[i, :len(blocks)] = blocks
        idx = torch.from_numpy(table).to(self.device)
        return {name: leaf[:, idx].reshape(leaf.shape[0], len(req_ids),
                                           pad_blocks * self.block_size,
                                           *leaf.shape[3:])
                for name, leaf in self.pool.items()}

    def scatter_new_token(self, req_ids: Sequence[int],
                          positions: Sequence[int],
                          cache: Dict[str, torch.Tensor]):
        """Write each request's row at ``positions[i]`` of the dense
        ``cache`` (every layer) back to its physical (block, slot), in
        place."""
        addr = np.zeros((3, len(req_ids)), np.int64)   # block, slot, pos
        for i, (rid, pos) in enumerate(zip(req_ids, positions)):
            addr[:, i] = (self.manager.tables[rid][pos // self.block_size],
                          pos % self.block_size, pos)
        phys, sib, pos = torch.from_numpy(addr).to(self.device)
        rows = torch.arange(len(req_ids), device=self.device)
        for name, leaf in self.pool.items():
            leaf[:, phys, sib] = cache[name][:, rows, pos].to(leaf.dtype)

    def release(self, rid: int):
        self.manager.release(rid)
