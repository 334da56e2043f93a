"""Every family of the registry as an ``nn.Module`` (counterpart of
``repro.models.model``): dense (causal, optionally with a sliding
window), the bidirectional encoder, the VLM (a cross-attention block
every ``cross_every`` layers over a request's image K/V), MoE, SSM
(Mamba2) and hybrid (Mamba2 with one shared attention block every
``attn_every`` layers).

Public entry points:
  forward      — full-sequence logits (token ids, or embeddings for a
                 config with ``embedding_inputs``; the encoder's entry)
  prefill      — process a (padded) prompt batch, or the suffix of one
                 over its cached prefix, return last-position logits
                 and every layer's cache entry
  decode_step  — one token for every request, either against a
                 :class:`~repro_torch.kvcache.view.PagedCacheView` (the
                 zero-copy paged path: block-table attention on the
                 physical pool, SSM state and image K/V read at the
                 view's slots) or against a dense cache (the static-batch
                 loop and the engine's gather fallback: contiguous decode
                 attention, a ring under a sliding window); new K/V rows
                 and new state are written in place either way
  init_cache   — a zeroed dense cache

Every cache is one flat dict (:func:`~repro_torch.models.params.
cache_layers`): ``k``/``v`` ``[n_kv_layers, B, S, K, hd]`` for the
self-attention layers (``ATTN`` and each ``SHARED_ATTN`` occurrence,
each with K/V of its own), ``h`` ``[n_ssm_layers, B, H, P, N]``
(float32) and ``conv`` ``[n_ssm_layers, B, W-1, conv_ch]`` for the SSM
layers, ``xk``/``xv`` ``[n_cross_layers, B, n_img_tokens, K, hd]`` for
the ``CROSS`` layers, each kind in plan order. The paged pool has the
same keys with the block (``k``/``v``) or slot (the state leaves) axis
in place of ``B``. Under a sliding window ``W`` the dense K/V is a ring
of ``min(length, W)`` slots: a prefill longer than ``W`` keeps its
bucket's last ``W`` rows, row ``t`` at slot ``t % W`` (the reference's
``_finalize_prefill_cache``, padding rows included, as there).

The reference stacks each period's layers under one ``lax.scan`` and
flattens the pool to ``[L*N, ...]`` with ``layer * N`` added to the
tables and slots; eager PyTorch needs neither, so each layer is a module
of its own and receives its contiguous pool layer.

An MoE block routes at the config's ``moe.capacity_factor`` in a
prefill and at ``serve_capacity_factor`` in a decode step, over every
row it is given, batch padding included, as the reference does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import CROSS, SHARED_ATTN, SSM, ArchConfig
from repro_torch.device import on_device, resolve_device
from repro_torch.kvcache.view import PagedCacheView
from repro_torch.models import attention
from repro_torch.models.layers import (decode_embed, embed_inputs,
                                       mlp_apply, norm_apply, unembed_apply)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (cache_layers, init_params,
                                       layer_sources, state_leaves)
from repro_torch.models.ssm import ssm_decode, ssm_seq

Tree = Dict[str, object]
Cache = Dict[str, torch.Tensor]


class Leaves(nn.Module):
    """One parameter group (e.g. ``attn``): named tensors registered as
    frozen parameters, handed to the layer functions as a dict."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def tree(self) -> Dict[str, torch.Tensor]:
        return dict(self._parameters)


class Block(nn.Module):
    """One pre-norm attention block: ``x + attn(ln1(x))``, then ``x +
    ffn(ln2(x))``, the FFN dense or (``moe``) routed."""

    def __init__(self, cfg: ArchConfig, leaves: Dict[str, Dict],
                 moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.moe = moe
        self.ln1 = Leaves(leaves["ln1"])
        self.attn = Leaves(leaves["attn"])
        self.ln2 = Leaves(leaves["ln2"])
        ffn = dict(leaves["ffn"])
        dense = ffn.pop("dense", None)
        self.ffn = Leaves(ffn)
        self.dense = Leaves(dense) if dense is not None else None

    def _ffn(self, x: torch.Tensor, capacity_factor: float) -> torch.Tensor:
        h = norm_apply(self.ln2.tree(), x, self.cfg)
        if not self.moe:
            return x + mlp_apply(self.ffn.tree(), h, self.cfg)
        p = self.ffn.tree()
        if self.dense is not None:
            p["dense"] = self.dense.tree()
        return x + moe_ffn(p, h, self.cfg, capacity_factor=capacity_factor)

    def seq(self, x: torch.Tensor, positions: torch.Tensor,
            lengths: Optional[torch.Tensor],
            prefix: Optional[Tuple[torch.Tensor, torch.Tensor]],
            prefix_len: Union[int, torch.Tensor],
            img_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
        pk, pv = prefix if prefix is not None else (None, None)
        h, (k, v) = attention.self_attn_seq(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            self.cfg, positions=positions, causal=self.cfg.causal,
            window=self.cfg.sliding_window, lengths=lengths, prefix_k=pk,
            prefix_v=pv, prefix_len=prefix_len)
        cf = self.cfg.moe.capacity_factor if self.moe else 1.0
        return self._ffn(x + h, cf), {"k": k, "v": v}

    def decode(self, x: torch.Tensor, entry: Cache, pos: torch.Tensor,
               lengths: Optional[torch.Tensor]) -> torch.Tensor:
        h = attention.self_attn_decode(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            entry["k"], entry["v"], self.cfg, pos=pos,
            window=self.cfg.sliding_window, lengths=lengths)
        return self._ffn(x + h, self.cfg.serve_capacity_factor)

    def decode_paged(self, x: torch.Tensor, entry: Cache,
                     view: PagedCacheView) -> torch.Tensor:
        h = attention.paged_self_attn_decode(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            entry["k"], entry["v"], self.cfg, tables=view.tables,
            lengths=view.lengths, positions=view.positions,
            block_size=view.block_size)
        return self._ffn(x + h, self.cfg.serve_capacity_factor)


class CrossBlock(Block):
    """One pre-norm cross-attention block (a VLM's ``CROSS`` layer): ``x
    + cross_attn(ln1(x))`` onto the request's image K/V, then ``x +
    mlp(ln2(x))``. A prefill projects the image embeddings to its K/V
    and returns them as the layer's entry ``{"xk", "xv"}``; a decode step
    reads them from the dense cache or, paged, from the pool's slots."""

    def seq(self, x: torch.Tensor, positions: torch.Tensor,
            lengths: Optional[torch.Tensor], prefix, prefix_len,
            img_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
        if prefix is not None:
            raise NotImplementedError("prefix KV reuse over cross-attention")
        if img_embeds is None:
            raise ValueError(f"{self.cfg.name}: a cross-attention layer "
                             f"needs img_embeds")
        p = self.attn.tree()
        k, v = attention.cross_attn_kv(p, img_embeds, self.cfg)
        h = attention.cross_attn_apply(
            p, norm_apply(self.ln1.tree(), x, self.cfg), k, v, self.cfg,
            decode=False)
        return self._ffn(x + h, 1.0), {"xk": k, "xv": v}

    def _attend(self, x: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        h = attention.cross_attn_apply(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg), k,
            v, self.cfg, decode=True)
        return self._ffn(x + h, self.cfg.serve_capacity_factor)

    def decode(self, x: torch.Tensor, entry: Cache, pos=None,
               lengths=None) -> torch.Tensor:
        return self._attend(x, entry["xk"], entry["xv"])

    def decode_paged(self, x: torch.Tensor, entry: Cache,
                     view: PagedCacheView) -> torch.Tensor:
        """Each row's image K/V gathered from its slot ``view.slots``
        (padding rows read the trash slot), as the reference's
        ``jnp.take`` gathers them."""
        slots = view.slots.long()
        return self._attend(x, entry["xk"].index_select(0, slots),
                            entry["xv"].index_select(0, slots))


class SSMBlock(nn.Module):
    """One pre-norm Mamba2 block: ``x + ssm(ln1(x))``."""

    def __init__(self, cfg: ArchConfig, leaves: Dict[str, Dict]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Leaves(leaves["ln1"])
        self.ssm = Leaves(leaves["ssm"])

    def seq(self, x: torch.Tensor, positions: torch.Tensor,
            lengths: Optional[torch.Tensor], prefix, prefix_len,
            img_embeds=None) -> Tuple[torch.Tensor, Cache]:
        if prefix is not None:
            raise NotImplementedError("prefix KV reuse over SSM state")
        h, state = ssm_seq(self.ssm.tree(),
                           norm_apply(self.ln1.tree(), x, self.cfg), self.cfg)
        return x + h, state

    def decode(self, x: torch.Tensor, entry: Cache, pos=None,
               lengths=None) -> torch.Tensor:
        """One token against the dense state ``entry`` ``{"h", "conv"}``
        (``[B, ...]`` views), rewritten in place."""
        h, new = ssm_decode(self.ssm.tree(),
                            norm_apply(self.ln1.tree(), x, self.cfg),
                            entry, self.cfg)
        for name, t in new.items():
            entry[name].copy_(t)
        return x + h

    def decode_paged(self, x: torch.Tensor, entry: Cache,
                     view: PagedCacheView) -> torch.Tensor:
        """One token against the pool's state at ``view.slots`` (padding
        rows name the trash slot), written back there."""
        slots = view.slots.long()
        state = {name: t.index_select(0, slots) for name, t in entry.items()}
        h, new = ssm_decode(self.ssm.tree(),
                            norm_apply(self.ln1.tree(), x, self.cfg),
                            state, self.cfg)
        for name, t in entry.items():
            t.index_copy_(0, slots, new[name].to(t.dtype))
        return x + h


class Model(nn.Module):
    """A model of any family of the registry on one device.

    ``params`` is a tree in the reference's layout (from
    :func:`~repro_torch.models.params.init_params` or
    :func:`~repro_torch.models.params.params_from_numpy`); without it the
    weights are drawn from ``generator`` (seed 0 by default) on the
    device. ``device=None`` means the card, and raises without one.
    """

    def __init__(self, cfg: ArchConfig, params: Optional[Tree] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, device=self.device)

        def to_dev(tree, rep=None):
            if isinstance(tree, dict):
                return {n: to_dev(t, rep) for n, t in tree.items()}
            return (tree if rep is None else tree[rep]).to(self.device)

        self.embed = Leaves(to_dev(params["embed"]))
        self.shared = Block(cfg, to_dev(params["shared"])) \
            if "shared" in params else None
        layers: List[nn.Module] = []
        for kind, (where, i, rep) in zip(cfg.block_plan(),
                                          layer_sources(cfg)):
            if kind == SHARED_ATTN:
                layers.append(self.shared)
                continue
            leaves = to_dev(params[where][i], rep)
            if kind == SSM:
                layers.append(SSMBlock(cfg, leaves))
            elif kind == CROSS:
                layers.append(CrossBlock(cfg, leaves))
            else:
                layers.append(Block(cfg, leaves, moe=cfg.moe is not None))
        self.layers = nn.ModuleList(layers)
        self.final_norm = Leaves(to_dev(params["final_norm"]))
        # each layer's cache keys and its index along their leading dim
        self._entries: List[Tuple[Tuple[str, ...], int]] = []
        keys_of = {"kv": ("k", "v"), "ssm": ("h", "conv"),
                   "cross": ("xk", "xv")}
        at = {i: keys_of[kind] for kind, ls in cache_layers(cfg).items()
              for i in ls}
        seen = {"k": 0, "h": 0, "xk": 0}
        for l in range(cfg.n_layers):
            keys = at[l]
            self._entries.append((keys, seen[keys[0]]))
            seen[keys[0]] += 1

    def _entry(self, cache: Cache, l: int) -> Cache:
        keys, i = self._entries[l]
        return {name: cache[name][i] for name in keys}

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """[B,1,D] final hidden -> [B, vocab] float32 logits."""
        x = norm_apply(self.final_norm.tree(), x, self.cfg)
        return unembed_apply(self.embed.tree(), x,
                             self.cfg)[:, 0, :self.cfg.vocab_size]

    def _embed_seq(self, tokens: Optional[torch.Tensor],
                   embeds: Optional[torch.Tensor],
                   prefix_len: Union[int, torch.Tensor] = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A sequence's input rows ``[B,S,D]`` and their positions (from
        ``prefix_len``): token ids, or embeddings for a config with
        ``embedding_inputs``."""
        dev = self.device
        some = tokens if tokens is not None else embeds
        if some is None:
            raise ValueError("a sequence needs tokens or embeds")
        positions = prefix_len + torch.arange(some.shape[1], device=dev)
        x = embed_inputs(self.embed.tree(), self.cfg, positions,
                         tokens=None if tokens is None else
                         on_device(tokens, dev),
                         embeds=None if embeds is None else
                         on_device(embeds, dev))
        return x, positions

    def _stack_seq(self, x: torch.Tensor, positions: torch.Tensor,
                   lengths: Optional[torch.Tensor], prefix: Optional[Cache],
                   prefix_len: Union[int, torch.Tensor],
                   img_embeds: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Cache]:
        """Every layer over a whole sequence: the last hidden rows (before
        the final norm) and each layer's cache entry, stacked by key."""
        if img_embeds is not None:
            img_embeds = on_device(img_embeds, self.device)
        parts: Dict[str, List[torch.Tensor]] = {}
        for l, blk in enumerate(self.layers):
            # an SSM layer's prefix is () (the prefix holds no state): it
            # refuses it, as the reference does
            keys, i = self._entries[l]
            pkv = None if prefix is None else tuple(
                prefix[n][i] for n in keys if n in prefix)
            x, entry = blk.seq(x, positions, lengths, pkv, prefix_len,
                               img_embeds=img_embeds)
            for name, t in entry.items():
                parts.setdefault(name, []).append(t)
        return x, {name: torch.stack(ts) for name, ts in parts.items()}

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                img_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence logits (the reference's ``forward``): ``tokens
        [B,S]``, or ``embeds [B,S,D]`` for a config with
        ``embedding_inputs`` (the encoder), with its learned positions;
        ``lengths [B]`` masks each row's keys at or past its length (the
        encoder attends both ways within it); ``img_embeds [B, n_img, D]``
        feed a VLM's cross-attention. Returns float32 ``[B, S, vocab]``."""
        x, positions = self._embed_seq(tokens, embeds)
        if lengths is not None:
            lengths = on_device(lengths, self.device).to(torch.int32)
        x, _ = self._stack_seq(x, positions, lengths, None, 0, img_embeds)
        x = norm_apply(self.final_norm.tree(), x, self.cfg)
        return unembed_apply(self.embed.tree(), x,
                             self.cfg)[..., :self.cfg.vocab_size]

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None,
                prefix: Optional[Cache] = None,
                prefix_len: Union[int, torch.Tensor] = 0, *,
                embeds: Optional[torch.Tensor] = None,
                img_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process a prompt batch ``tokens [B,S]`` (right-padded, valid
        lengths ``lengths [B]``; ``embeds [B,S,D]`` instead for a config
        with ``embedding_inputs``; a VLM also takes ``img_embeds [B,
        n_img, D]``). Returns ``(logits [B, vocab], cache)``: float32
        logits at each request's last valid position, and the cache
        (module docstring) with K/V ``[n_kv, B, max(S, cache_len), K,
        hd]`` (rows past ``S`` zero; under a sliding window ``W`` a ring of
        ``W`` slots when ``S > W``, else ``min(max(S, cache_len), W)``
        slots), each SSM layer's state after all ``S`` rows, padding rows
        included (the reference's state ignores the lengths too), and
        each ``CROSS`` layer's image K/V.

        Suffix-only prefill (the prefix cache, and each chunk of a
        chunked prefill; attention-only plans): ``prefix`` is ``{"k",
        "v"}`` of ``[n_kv, B, P_pad, K, hd]`` dense prefix K/V (e.g. from
        :meth:`~repro_torch.kvcache.paged.PagedKVCache.gather_prefix`) of
        which the first ``prefix_len`` rows are valid, and ``tokens``
        holds only the suffix: positions start at ``prefix_len``,
        ``lengths`` (required) stay suffix-local, and the returned cache
        covers the suffix alone (the reference's ``prefill(prefix=,
        prefix_len=)``). ``prefix_len`` may be a 0-dim int32 tensor on
        the device (a captured step's staged length): nothing here reads a
        tensor back to the host."""
        dev = self.device
        x, positions = self._embed_seq(tokens, embeds, prefix_len)
        B, S = x.shape[:2]
        attn_lengths = None
        if lengths is not None:
            lengths = on_device(lengths, dev)
            attn_lengths = (lengths + prefix_len).to(torch.int32)
        elif prefix is not None:
            raise ValueError("suffix prefill requires lengths")
        x, cache = self._stack_seq(x, positions, attn_lengths, prefix,
                                   prefix_len, img_embeds)
        if lengths is not None:
            last = lengths.long() - 1
            x = x[torch.arange(B, device=dev), last][:, None]
        else:
            x = x[:, -1:]
        for name in ("k", "v"):
            if name in cache:
                cache[name] = self._finalize(cache[name], S, cache_len)
        return self._logits(x), cache

    def _finalize(self, a: torch.Tensor, S: int,
                  cache_len: Optional[int]) -> torch.Tensor:
        """A prefill's K/V ``[n_kv, B, S, K, hd]`` in its decode layout
        (the reference's ``_finalize_prefill_cache``): under a window
        ``W < S`` the ring of the last ``W`` rows, row ``t`` at slot ``t %
        W``; else padded with zero rows to ``min(cache_len, W)``."""
        W = self.cfg.sliding_window
        if W is not None and S > W:
            return torch.roll(a[:, :, S - W:], shifts=(S - W) % W, dims=2)
        target = cache_len or S
        if W is not None:
            target = min(target, W)
        if target > S:
            a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, target - S))
        return a

    def init_cache(self, batch: int, kv_len: int) -> Cache:
        """A zeroed dense cache (module docstring) for ``batch`` rows of
        ``kv_len`` K/V slots (``min(kv_len, W)`` under a sliding window
        ``W``), on the model's device."""
        cfg, dev = self.cfg, self.device
        if cfg.sliding_window:
            kv_len = min(kv_len, cfg.sliding_window)
        out = {}
        n_kv = len(cache_layers(cfg)["kv"])
        if n_kv:
            shape = (n_kv, batch, kv_len, cfg.n_kv_heads, cfg.hd)
            out = {name: torch.zeros(shape, dtype=cfg.activation_dtype,
                                     device=dev) for name in ("k", "v")}
        for name, (shape, dtype) in state_leaves(cfg, batch).items():
            out[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return out

    @torch.no_grad()
    def decode_step(self, tokens: Optional[torch.Tensor],
                    cache: Union[PagedCacheView, Cache],
                    pos: Optional[Union[int, torch.Tensor]] = None,
                    lengths: Optional[torch.Tensor] = None, *,
                    embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token for every row (``tokens [B]``, or ``embeds [B,1,D]``
        taken as they are); returns float32 logits ``[B, vocab]``.

        With a :class:`PagedCacheView` the positions, lengths and state
        slots come from the view, and each layer's new K/V rows and new
        state go into ``view.pool``. With a dense cache (from
        :meth:`prefill` or :meth:`init_cache`) ``pos`` is one position
        for the batch or a ``[B]`` tensor, ``lengths`` the optional
        ``[B]`` valid lengths (see
        :func:`~repro_torch.models.attention.self_attn_decode`), and the
        cache is **updated in place**, where the reference returns a new
        one.
        """
        if isinstance(cache, PagedCacheView):
            x = decode_embed(self.embed.tree(), self.cfg, tokens,
                             cache.positions.long()[:, None], embeds)
            for l, blk in enumerate(self.layers):
                x = blk.decode_paged(x, self._entry(cache.pool, l), cache)
            return self._logits(x)
        if pos is None:
            raise ValueError("decode_step on a dense cache needs pos")
        pos = on_device(pos, self.device)
        emb_pos = pos.long()[:, None] if pos.dim() else pos.long().reshape(1)
        x = decode_embed(self.embed.tree(), self.cfg, tokens, emb_pos, embeds)
        for l, blk in enumerate(self.layers):
            x = blk.decode(x, self._entry(cache, l), pos, lengths)
        return self._logits(x)
