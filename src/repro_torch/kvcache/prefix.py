"""Radix-style prefix cache over the paged KV pool (the port's copy of
``repro.kvcache.prefix``).

When many requests share a system prompt, each of them would prefill and
store the same KV blocks. The index turns that into shared blocks and
skipped prefill:

* **Block-granular radix tree.** A node per *full* ``block_size``-token
  chunk of a prompt, children keyed by the chunk's token ids, each node
  pinning one physical pool block through a cache reference
  (:meth:`~repro_torch.kvcache.paged.BlockManager.incref`), so a
  request's release does not free indexed blocks.
* **Match = splice, not copy.** :meth:`PrefixIndex.match` walks the tree
  over a prompt's leading full blocks; the engine splices the matched
  physical blocks into the request's block table
  (:meth:`~repro_torch.kvcache.paged.BlockManager.share`) and prefills
  only the uncached suffix. Paged decode only ever sees block tables.
* **LRU eviction under the watermark.** Cached blocks whose only
  reference is the cache are reclaimable; :meth:`PrefixIndex.evict` drops
  least-recently-used leaves until enough blocks are freed.

The match is capped at ``prompt_len - 1`` tokens so at least one token is
always computed: prefill must produce the first output logits.

Eligibility: prefix reuse assumes a token's KV depends only on the
tokens before it, which holds for causal full attention over token ids
and not for recurrent state, cross-attention, sliding-window ring caches,
MoE with finite expert capacity, bidirectional attention or embedding
inputs (:func:`prefix_cache_supported`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ATTN, SHARED_ATTN, ArchConfig
from repro_torch.kvcache.paged import BlockManager


def prefix_cache_supported(cfg: ArchConfig) -> Tuple[bool, Optional[str]]:
    """(ok, reason-if-not): can prompts of this config share KV blocks?
    The reference's gate: every block of the plan must be a
    self-attention block (SSM state and a VLM's per-slot image K/V are
    not per-token addressable), causal, without a sliding window, without
    capacity routing, over token ids. Its reasons also turn chunked
    prefill and speculation off: the engine serves the MoE, SSM, hybrid
    and VLM families with all three off, and refuses the encoder and
    sliding-window configs outright (no decode step of the reference's
    engine runs them)."""
    if any(k not in (ATTN, SHARED_ATTN) for k in cfg.block_plan()):
        return False, ("non-attention state (SSM/cross-attn) is not "
                       "per-token addressable")
    if not cfg.causal:
        return False, "bidirectional attention: KV depends on the suffix"
    if cfg.sliding_window:
        return False, "sliding-window ring caches are not paged"
    if cfg.moe is not None:
        return False, ("MoE capacity routing couples a token's output to "
                       "its prefill batch")
    if cfg.embedding_inputs:
        return False, "prompts are embeddings, not hashable token ids"
    return True, None


@dataclasses.dataclass
class PrefixStats:
    """Counters for the reuse the cache actually delivered."""
    lookups: int = 0             # admitted requests that consulted the index
    hits: int = 0                # lookups that matched >= 1 cached block
    prompt_tokens: int = 0       # prompt tokens across admitted lookups
    hit_tokens: int = 0          # prefill tokens skipped (served from cache)
    blocks_shared: int = 0       # cached blocks spliced into request tables
    blocks_inserted: int = 0     # new blocks registered in the index
    blocks_evicted: int = 0      # cached blocks dropped (freed to the pool)

    @property
    def hit_rate(self) -> float:
        """Fraction of prompt tokens served from cache (the BCA input)."""
        return self.hit_tokens / self.prompt_tokens if self.prompt_tokens \
            else 0.0

    def row(self) -> str:
        return (f"hit_rate={self.hit_rate * 100:.1f}% "
                f"skipped={self.hit_tokens} tok  "
                f"shared={self.blocks_shared} blk  "
                f"evicted={self.blocks_evicted} blk")


class _Node:
    __slots__ = ("chunk", "block", "parent", "children", "last_used")

    def __init__(self, chunk: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixIndex:
    """Radix tree mapping token-id block chunks to physical pool blocks."""

    def __init__(self, manager: BlockManager, *,
                 max_blocks: Optional[int] = None):
        self.manager = manager
        self.block_size = manager.block_size
        self.max_blocks = max_blocks
        self.stats = PrefixStats()
        self._root = _Node(None, -1, None)
        self._cached = 0             # nodes (== blocks) currently indexed
        self._clock = 0              # LRU counter (monotonic, not wall time)

    @property
    def cached_blocks(self) -> int:
        return self._cached

    def held_blocks(self) -> List[int]:
        """Physical blocks the cache *alone* keeps alive (ref count 1:
        indexed but in no request's table). These are the pool bytes the
        memory-gap auditor attributes to "prefix-cache-held" — warm
        capacity that is neither free nor serving a live request."""
        return [n.block for n in self._iter_nodes()
                if self.manager.ref_count(n.block) == 1]

    def indexed_blocks(self) -> List[int]:
        """Every physical block the index references (held or shared)."""
        return [n.block for n in self._iter_nodes()]

    # --------------------------------------------------------- lookup ----
    def _chunks(self, tokens: np.ndarray, n_full: int):
        bs = self.block_size
        for i in range(n_full):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached full-block prefix of ``tokens``.

        Returns the physical block ids, capped so at least one prompt
        token remains for the suffix prefill. Matched nodes are touched
        for LRU. Does not take references — the caller must
        :meth:`BlockManager.share` the blocks before anything can evict.
        """
        toks = np.asarray(tokens)
        limit = (len(toks) - 1) // self.block_size
        node, blocks = self._root, []
        for chunk in self._chunks(toks, limit):
            child = node.children.get(chunk)
            if child is None:
                break
            self._clock += 1
            child.last_used = self._clock
            blocks.append(child.block)
            node = child
        return blocks

    def record_admit(self, prompt_len: int, hit_tokens: int):
        """Fold one *admitted* request into the stats (match() itself is
        side-effect free so capacity-blocked retries don't double count)."""
        self.stats.lookups += 1
        self.stats.prompt_tokens += prompt_len
        if hit_tokens:
            self.stats.hits += 1
            self.stats.hit_tokens += hit_tokens
            self.stats.blocks_shared += hit_tokens // self.block_size

    # --------------------------------------------------------- insert ----
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Register a prefilled prompt's full blocks; returns new nodes.

        ``blocks`` is the request's block table (cached prefix first, then
        its own). Existing nodes are kept (first writer wins) and only
        touched; new chunks pin this request's physical block with a cache
        reference so it survives the request's release.
        """
        toks = np.asarray(tokens)
        n_full = min(len(toks) // self.block_size, len(blocks))
        node, added = self._root, 0
        for i, chunk in enumerate(self._chunks(toks, n_full)):
            child = node.children.get(chunk)
            if child is None:
                # protect the attachment point: it may itself be a
                # cache-only leaf right now, and evicting it would attach
                # the new child to a detached node (leaking its block)
                if self.max_blocks is not None \
                        and self._cached >= self.max_blocks \
                        and not self.evict(1, protect=node):
                    break
                child = _Node(chunk, blocks[i], node)
                node.children[chunk] = child
                self.manager.incref(blocks[i])
                self._cached += 1
                self.stats.blocks_inserted += 1
                added += 1
            self._clock += 1
            child.last_used = self._clock
            node = child
        return added

    # -------------------------------------------------------- evict ------
    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _remove(self, node: _Node):
        del node.parent.children[node.chunk]
        self.manager.decref(node.block)
        self._cached -= 1
        self.stats.blocks_evicted += 1

    def evict(self, n_blocks: int, protect: Optional[_Node] = None) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU leaves.

        Only nodes whose block the cache alone references are candidates —
        evicting a block a running request still holds would free nothing
        (and lose a warm entry for no gain). Evicting a leaf can expose
        its parent, so the walk repeats until satisfied or dry. Returns
        the number of blocks actually freed to the pool.

        ``protect`` exempts one node (insert's current attachment point —
        its ancestors have children and are never leaves, so protecting
        the point itself suffices).

        The full-tree walk + sort per call is O(cached blocks); fine at
        this repo's scale (hundreds of blocks), and only paid when the
        pool is actually short. An O(1)-pop LRU list of evictable leaves
        would need invalidation hooks on every external ref-count change
        (request release/share) — not worth the coupling yet.
        """
        freed = 0
        while freed < n_blocks:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and n is not protect
                      and self.manager.ref_count(n.block) == 1]
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for n in leaves:
                if freed >= n_blocks:
                    break
                self._remove(n)
                freed += 1
        return freed

    def clear(self) -> int:
        """Drop every entry (references included); returns blocks freed."""
        freed = 0
        for n in list(self._iter_nodes()):
            if self.manager.decref(n.block):
                freed += 1
            self.stats.blocks_evicted += 1
        self._root.children.clear()
        self._cached = 0
        return freed
