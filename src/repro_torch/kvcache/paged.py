"""Paged KV cache (counterpart of ``repro.kvcache.paged``).

Physical KV blocks live in one pool tensor per K and V, and a
per-request table of block ids maps logical to physical positions.
Allocation is at block granularity from a free list, with admission
control by a free-block watermark (:class:`BlockManager`, a copy of the
reference's).

:class:`PagedKVCache` holds the pool as ``{"k", "v"}``, each
``[n_kv, NB+1, BS, K, hd]`` in the model's dtype on its device, over the
attention layers of the block plan. Block ``NB`` is the *trash* block:
batch-padding rows write there, so the engine can pad the running batch
to power-of-two buckets without touching live state. A plan with SSM
or ``CROSS`` layers also holds per-request state in dense slots (the
reference's dense-state leaves): SSM layers' ``{"h", "conv"}``, each
``[n_ssm, max_batch+1, ...]`` (``h`` float32, ``conv`` the model's
dtype), and ``CROSS`` layers' image K/V ``{"xk", "xv"}``, each
``[n_cross, max_batch+1, n_img_tokens, K, hd]``, written by the
request's prefill and only read after it. A request takes a slot at its
prefill and gives it back with its blocks
(:meth:`PagedKVCache.release`: on finish, abort, eviction and
preemption); slot ``max_batch`` is the *trash* slot of padding rows.
Writes are **in place** (``index_copy_`` / ``index_put_``) where the
reference rebuilds donated buffers. Decode reads the pool either
through a :class:`PagedCacheView` (zero-copy) or, in the gather
fallback, through a dense copy (:meth:`PagedKVCache.gather`) whose new
rows :meth:`PagedKVCache.scatter_new_token` writes back. Suffix-only and
chunked prefill read a request's written prefix through
:meth:`PagedKVCache.gather_prefix` and write their rows token by token
(:meth:`PagedKVCache.write_prefill` with ``n_tokens``);
:meth:`PagedKVCache.ensure_writable` forks a shared block before a write,
and :meth:`PagedKVCache.rollback` releases the table tail a speculative
verify step reserved for drafts that did not commit.

Those eager methods build their indices on the host and upload them. The
engine's steps (:mod:`repro_torch.serving.steps`) stage the same indices
in one packed upload (:meth:`PagedKVCache.fill_prefill`,
:meth:`PagedKVCache.fill_view`) and then gather and write through them on
the device alone (:meth:`PagedKVCache.gather_tables`,
:meth:`PagedKVCache.write_rows`, :meth:`PagedKVCache.scatter_rows`), so
that a CUDA graph can capture the step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kvcache.view import PagedCacheView, step_fields, step_size
from repro_torch.models.params import (READ_ONLY_STATE, cache_layers,
                                       state_leaves)

Fields = Dict[str, np.ndarray]


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
    """Physical paged pool: self-attention K/V in blocks and, for SSM and
    ``CROSS`` layers, dense-state slots (``max_batch`` of them; required
    then)."""

    def __init__(self, cfg: ArchConfig, *, num_blocks: int, block_size: int,
                 device: torch.device, max_batch: Optional[int] = None):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.device = torch.device(device)
        self.manager = BlockManager(num_blocks, block_size)
        self.trash_block = num_blocks          # physical block for padding
        layers = cache_layers(cfg)
        self.pool: Dict[str, torch.Tensor] = {}
        if layers["kv"]:
            shape = (len(layers["kv"]), num_blocks + 1, block_size,
                     cfg.n_kv_heads, cfg.hd)
            self.pool = {name: torch.zeros(shape, dtype=cfg.activation_dtype,
                                           device=self.device)
                         for name in ("k", "v")}
        self.kv_names = tuple(self.pool)
        if (layers["ssm"] or layers["cross"]) and max_batch is None:
            raise ValueError(f"{cfg.name}: a pool with per-request state "
                             f"needs max_batch (its dense-state slots)")
        self.max_batch = max_batch or 0
        self.trash_slot = self.max_batch       # dense slot for padding
        for name, (shape, dtype) in state_leaves(
                cfg, self.max_batch + 1).items():
            self.pool[name] = torch.zeros(shape, dtype=dtype,
                                          device=self.device)
        self.state_names = tuple(n for n in self.pool
                                 if n not in self.kv_names)
        # the state a decode step writes back (the image K/V it only reads)
        self.written_state = tuple(n for n in self.state_names
                                   if n not in READ_ONLY_STATE)
        self._reset_slots()
        # one physical block's bytes summed over every paged leaf, and the
        # dense-state slots' bytes (the reference's accounting, each
        # integer-equal to it)
        self.block_bytes: int = sum(
            self.pool[n].numel() * self.pool[n].element_size()
            // (num_blocks + 1) for n in self.kv_names)
        self.dense_state_bytes: int = sum(
            self.pool[n].numel() * self.pool[n].element_size()
            for n in self.state_names)

    def _reset_slots(self):
        self._slots: Dict[int, int] = {}
        self._free_slots: List[int] = list(range(self.max_batch)) \
            if self.state_names else []

    def reset(self):
        """Forget every allocation (a fresh allocator over the same
        tensors, every slot free): the pool of a respawned engine, whose
        stream has been drained. The blocks' and slots' contents stay;
        nothing reads one before it is written again."""
        self.manager = BlockManager(self.num_blocks, self.block_size)
        self._reset_slots()

    @property
    def free_slots(self) -> int:
        """Dense-state slots free (0 for a pool without state)."""
        return len(self._free_slots)

    def _slot(self, rid: int) -> int:
        """``rid``'s dense-state slot, taken on first use (the
        reference's ``_slot``; the trash slot for a pool without state)."""
        if not self.state_names:
            return self.trash_slot
        if rid not in self._slots:
            if not self._free_slots:
                raise RuntimeError(
                    f"no free dense-state slot for request {rid}: "
                    f"{self.max_batch} slots, all held")
            self._slots[rid] = self._free_slots.pop()
        return self._slots[rid]

    @property
    def pool_bytes(self) -> int:
        """Accountable pool bytes: every real physical block (the trash
        block never holds request state and is excluded)."""
        return self.block_bytes * self.num_blocks

    @property
    def token_bytes(self) -> float:
        """KV bytes one written token occupies (block_bytes/block_size)."""
        return self.block_bytes / self.block_size

    def write_prefill(self, req_id: int, cache_one: Dict[str, torch.Tensor],
                      start_pos: int = 0, n_tokens: Optional[int] = None):
        """Store one request's prefill K/V (``[L, 1, S, K, hd]`` leaves)
        in place.

        Without ``n_tokens`` the view fills the request's blocks from the
        block-aligned ``start_pos`` on (a suffix-only prefill leaves the
        cached prefix's blocks alone); rows past the table's capacity are
        dropped and a partly covered last block is zero-padded.

        With ``n_tokens`` the write is token-granular (the chunk scatter):
        the view's first ``n_tokens`` rows go to the (block, slot) of
        positions ``start_pos ..`` (any ``start_pos``: a chunk may end
        mid-block), and its padding rows to the trash block. Every index
        is taken from inside the table; a write past the table raises
        (extend it first)."""
        if n_tokens is not None:
            return self._write_token_range(req_id, cache_one, start_pos,
                                           n_tokens)
        if start_pos % self.block_size:
            raise ValueError(
                f"start_pos ({start_pos}) must be block-aligned "
                f"(block_size={self.block_size}); pass n_tokens for the "
                f"token-granular chunk path")
        blocks = self.manager.tables[req_id][start_pos // self.block_size:]
        nb = len(blocks)
        S_cap = nb * self.block_size
        phys = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        slot = self._slot(req_id)
        for name in self.state_names:
            self.pool[name][:, slot] = cache_one[name][:, 0].to(
                self.pool[name].dtype)
        for name in self.kv_names:
            leaf = self.pool[name]
            v = cache_one[name][:, 0, :S_cap]                  # [L,S,K,hd]
            if v.shape[1] < S_cap:
                v = torch.nn.functional.pad(
                    v, (0, 0, 0, 0, 0, S_cap - v.shape[1]))
            v = v.reshape(v.shape[0], nb, self.block_size, *v.shape[2:])
            leaf.index_copy_(1, phys, v.to(leaf.dtype))

    def _write_token_range(self, req_id: int,
                           cache_one: Dict[str, torch.Tensor],
                           start_pos: int, n_tokens: int):
        """Scatter the view's rows: the first ``n_tokens`` to positions
        ``[start_pos, start_pos + n_tokens)``, the rest to the trash
        block (the reference's ``scatter_chunk_jit``, whose clipped
        table index the port does not need)."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        self._no_state("token-granular prefill writes")
        table = self.manager.tables.get(req_id, [])
        end = start_pos + n_tokens
        if end > len(table) * self.block_size:
            raise ValueError(
                f"chunk write [{start_pos}, {end}) over-allocates past "
                f"req {req_id}'s table ({len(table)} blocks x "
                f"{self.block_size}); extend() the table first")
        S = cache_one["k"].shape[2]
        if S < n_tokens:
            raise ValueError(f"the view holds {S} rows, fewer than "
                             f"n_tokens={n_tokens}")
        pos = start_pos + np.arange(S)
        addr = np.empty((2, S), np.int64)                    # block, slot
        addr[0] = self.trash_block
        addr[0, :n_tokens] = np.asarray(table, np.int64)[
            pos[:n_tokens] // self.block_size]
        addr[1] = pos % self.block_size
        phys, sib = torch.from_numpy(addr).to(self.device)
        for name in self.kv_names:
            leaf = self.pool[name]
            leaf[:, phys, sib] = cache_one[name][:, 0].to(leaf.dtype)

    def _no_state(self, what: str):
        """Refuse a per-token operation on a pool with dense state (the
        reference's refusal; the engine never asks for one)."""
        if self.state_names:
            raise NotImplementedError(
                f"{what} over non-KV (dense-state) leaves: chunked prefill "
                f"and the prefix cache require per-token state")

    def gather_prefix(self, blocks: Sequence[int],
                      nb_pad: int) -> Dict[str, torch.Tensor]:
        """Dense prefix K/V for a suffix-only or chunk prefill: ``{"k",
        "v"}``, each ``[L, 1, nb_pad * BS, K, hd]``, holding ``blocks``
        (the prompt's first ``len(blocks)`` blocks) and the trash block
        past them; the attention masks rows past the valid prefix length
        (``prefix_len``)."""
        self._no_state("prefix gather")
        table = np.full((nb_pad,), self.trash_block, np.int64)
        blocks = list(blocks)[:nb_pad]
        table[:len(blocks)] = blocks
        idx = torch.from_numpy(table).to(self.device)
        P = nb_pad * self.block_size
        return {name: self.pool[name][:, idx].reshape(
                    self.pool[name].shape[0], 1, P, *self.pool[name].shape[3:])
                for name in self.kv_names}

    def fill_prefill(self, fields: Fields, req_id: int,
                     tokens: Sequence[int], start: int, prefix_blocks: int):
        """Stage one prefill of prompt positions ``[start, start + n)``
        (``n = len(tokens)``) in the host ``fields`` of
        :func:`~repro_torch.kvcache.view.prefill_fields`, whose shapes give
        the row bucket ``S`` and the prefix pad ``nb_pad``: the tokens
        (zeros past ``n``), ``n``, ``start`` as the prefix's valid length,
        the request's first ``prefix_blocks`` blocks then the trash block,
        and each row's write address, rows past ``n`` to the trash block
        (the token-granular write of :meth:`write_prefill` with
        ``n_tokens``, for every prefill), and the request's dense-state
        slot (taken here; the trash slot for a pool without state). A
        write past the table raises (extend it first), as does a prefix
        longer than its pad, and a prefix over dense state."""
        S = fields["tokens"].shape[1]
        nb_pad = fields["table"].shape[0]
        n = len(tokens)
        if not 1 <= n <= S:
            raise ValueError(f"a prefill of {n} tokens does not fit its "
                             f"bucket of {S} rows")
        if start > nb_pad * self.block_size:
            raise ValueError(f"prefix of {start} tokens exceeds its pad of "
                             f"{nb_pad} blocks x {self.block_size}")
        table = self.manager.tables.get(req_id, [])
        if start + n > len(table) * self.block_size:
            raise ValueError(
                f"prefill write [{start}, {start + n}) over-allocates past "
                f"req {req_id}'s table ({len(table)} blocks x "
                f"{self.block_size}); extend() the table first")
        fields["tokens"][0, :n] = tokens
        fields["tokens"][0, n:] = 0
        fields["n"][0] = n
        fields["prefix_len"][()] = start
        prefix = table[:min(prefix_blocks, nb_pad)]
        fields["table"][:] = self.trash_block
        fields["table"][:len(prefix)] = prefix
        pos = start + np.arange(S)
        fields["blocks"][:] = self.trash_block
        fields["blocks"][:n] = np.asarray(table)[pos[:n] // self.block_size]
        fields["slots"][:] = pos % self.block_size
        if start:
            self._no_state("a prefill over a prefix")
        fields["state_slot"][0] = self._slot(req_id)

    def gather_tables(self, tables: torch.Tensor,
                      slots: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """A dense copy ``{"k", "v"}``, each ``[n_kv, B, nb * BS, K,
        hd]``, of the blocks named by the device tables ``[B, nb]``: the
        prefix of a prefill (B = 1) or the gather step's caches; with
        ``slots [B]``, also every state leaf (``{"h", "conv"}``
        ``[n_ssm, B, ...]``, ``{"xk", "xv"}`` ``[n_cross, B, ...]``) at
        those dense-state slots. Issues no upload."""
        B, nb = tables.shape
        idx = tables.long()
        out = {name: self.pool[name][:, idx].reshape(
                   self.pool[name].shape[0], B, nb * self.block_size,
                   *self.pool[name].shape[3:])
               for name in self.kv_names}
        if slots is not None:
            for name in self.state_names:
                out[name] = self.pool[name][:, slots.long()]
        return out

    def write_rows(self, cache_one: Dict[str, torch.Tensor],
                   blocks: torch.Tensor, slots: torch.Tensor,
                   state_slot: Optional[torch.Tensor] = None):
        """Write a prefill's rows (``[n_kv, 1, S, K, hd]`` leaves) in place
        at the staged device addresses ``(blocks[i], slots[i])`` (the
        reference's ``scatter_chunk_jit``), and its final state
        (``[n_ssm, 1, ...]``) and image K/V (``[n_cross, 1, ...]``) at
        the staged dense-state slot ``state_slot [1]``. Issues no
        upload."""
        phys, sib = blocks.long(), slots.long()
        for name in self.kv_names:
            leaf = self.pool[name]
            leaf[:, phys, sib] = cache_one[name][:, 0].to(leaf.dtype)
        for name in self.state_names:
            leaf = self.pool[name]
            leaf.index_copy_(1, state_slot.long(),
                             cache_one[name].to(leaf.dtype))

    def scatter_rows(self, tables: torch.Tensor, positions: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     slots: Optional[torch.Tensor] = None):
        """The gather step's write back: row ``b`` of the dense ``cache``
        at ``positions[b]`` (every layer) to its physical (block, slot),
        the address computed on the device from the step's ``tables``
        (:meth:`scatter_new_token` computes it on the host), and each
        row's state to its dense-state slot ``slots[b]`` (not the image
        K/V, which a decode step does not change: the reference writes
        the same values back)."""
        rows = torch.arange(tables.shape[0], device=tables.device)
        pos = positions.long()
        phys = tables.long()[rows, pos // self.block_size]
        sib = pos % self.block_size
        for name in self.kv_names:
            leaf = self.pool[name]
            leaf[:, phys, sib] = cache[name][:, rows, pos].to(leaf.dtype)
        for name in self.written_state:
            leaf = self.pool[name]
            leaf.index_copy_(1, slots.long(), cache[name].to(leaf.dtype))

    def ensure_writable(self, req_id: int, pos: int):
        """Copy-on-write fork of the block holding ``pos`` if another
        owner shares it: a fresh block takes a copy of its contents on
        the device and the request's table entry. A no-op for a private
        block (the common case: a dictionary lookup)."""
        if not self.manager.needs_cow(req_id, pos):
            return
        old, new = self.manager.copy_on_write(req_id, pos // self.block_size)
        for name in self.kv_names:
            self.pool[name][:, new] = self.pool[name][:, old]

    def fill_view(self, fields: Dict[str, np.ndarray],
                  req_ids: Sequence[int], positions: Sequence[int]):
        """Write a decode step's block tables, lengths, positions and
        dense-state slots into the host ``fields`` of
        :func:`~repro_torch.kvcache.view.step_fields` (whose shapes give
        ``batch_pad`` and ``nb_pad``).

        ``positions[i]`` is the write position of request i's new token.
        Rows past ``len(req_ids)`` are padding: a table row of trash
        blocks, position 0, length 0 and the trash slot. (The reference
        lets padding rows drift to small nonzero positions, which its
        clamped gathers tolerate; here every padding row is rebuilt each
        step so that its write address ``tables[i, 0]`` is always in
        range.)
        """
        table = fields["tables"]
        batch_pad, nb_pad = table.shape
        B = len(req_ids)
        if B > batch_pad:
            raise ValueError(f"{B} requests exceed batch_pad={batch_pad}")
        table[:] = self.trash_block
        for i, rid in enumerate(req_ids):
            blocks = self.manager.tables.get(rid, [])[:nb_pad]
            table[i, :len(blocks)] = blocks
        pos, lens = fields["positions"], fields["lengths"]
        pos[:] = 0
        pos[:B] = positions
        lens[:] = 0
        lens[:B] = pos[:B] + 1
        slots = fields["slots"]
        slots[:] = self.trash_slot
        slots[:B] = [self._slot(rid) for rid in req_ids]

    def view(self, req_ids: Sequence[int], positions: Sequence[int],
             nb_pad: int, batch_pad: int) -> PagedCacheView:
        """Zero-copy :class:`PagedCacheView` over the pool for ``req_ids``
        in fresh device tensors (one upload); ``nb_pad``/``batch_pad`` are
        the bucketed table width and batch size, and the rows are
        :meth:`fill_view`'s. The engine's steps fill static buffers
        instead (:mod:`repro_torch.serving.steps`)."""
        buf = np.zeros((step_size(batch_pad, nb_pad),), np.int32)
        self.fill_view(step_fields(buf, batch_pad, nb_pad), req_ids,
                       positions)
        dev = step_fields(torch.from_numpy(buf).to(self.device), batch_pad,
                          nb_pad)
        return PagedCacheView(self.pool, dev["tables"], dev["lengths"],
                              dev["positions"], self.block_size,
                              dev["slots"])

    def gather(self, req_ids: Sequence[int],
               pad_blocks: int) -> Dict[str, torch.Tensor]:
        """A dense copy of the requests' caches (the gather fallback):
        ``{"k", "v"}``, each ``[n_kv, B, pad_blocks * BS, K, hd]``, and
        their state at their slots. Slots past a request's allocation
        read the trash block; the decode step's lengths mask them."""
        table = np.full((len(req_ids), pad_blocks), self.trash_block,
                        np.int64)
        for i, rid in enumerate(req_ids):
            blocks = self.manager.tables.get(rid, [])[:pad_blocks]
            table[i, :len(blocks)] = blocks
        slots = torch.tensor([self._slot(r) for r in req_ids],
                             device=self.device)
        return self.gather_tables(torch.from_numpy(table).to(self.device),
                                  slots)

    def scatter_new_token(self, req_ids: Sequence[int],
                          positions: Sequence[int],
                          cache: Dict[str, torch.Tensor]):
        """Write each request's row at ``positions[i]`` of the dense
        ``cache`` (every layer) back to its physical (block, slot), and
        its state (not its image K/V) to its slot, in place."""
        addr = np.zeros((3, len(req_ids)), np.int64)   # block, slot, pos
        for i, (rid, pos) in enumerate(zip(req_ids, positions)):
            addr[:, i] = (self.manager.tables[rid][pos // self.block_size],
                          pos % self.block_size, pos)
        phys, sib, pos = torch.from_numpy(addr).to(self.device)
        rows = torch.arange(len(req_ids), device=self.device)
        for name in self.kv_names:
            leaf = self.pool[name]
            leaf[:, phys, sib] = cache[name][:, rows, pos].to(leaf.dtype)
        slots = torch.tensor([self._slot(r) for r in req_ids],
                             device=self.device)
        for name in self.written_state:
            self.pool[name].index_copy_(1, slots,
                                        cache[name].to(self.pool[name].dtype))

    def rollback(self, rid: int, n_tokens: int) -> List[int]:
        """Shrink ``rid``'s KV to its first ``n_tokens`` tokens (the
        reference's ``rollback``): the table is truncated to the blocks
        those tokens need, and whole blocks past them are released
        (ref-counted: a prefix-shared block survives in its other owners'
        tables and in the prefix index). Rows past ``n_tokens`` in the
        kept tail block are not zeroed: the lengths mask them, and the
        next write at those positions lands on the same (block, slot).
        Returns the dropped physical block ids."""
        if n_tokens < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
        return self.manager.truncate(rid,
                                     self.manager.blocks_needed(n_tokens))

    def release(self, rid: int):
        """Free ``rid``'s blocks and its dense-state slot."""
        self.manager.release(rid)
        if rid in self._slots:
            self._free_slots.append(self._slots.pop(rid))
