"""The dense decoder as an ``nn.Module`` (counterpart of
``repro.models.model`` for ``arch_type == "dense"``).

Public entry points:
  prefill      — process a (padded) prompt batch, return last-position
                 logits and every layer's K/V
  decode_step  — one token for every request, either against a
                 :class:`~repro_torch.kvcache.view.PagedCacheView` (the
                 zero-copy paged path: block-table attention on the
                 physical pool) or against a dense ``{"k", "v"}`` cache
                 (the static-batch loop and the engine's gather
                 fallback: contiguous decode attention); new K/V rows are
                 written in place either way
  init_cache   — a zeroed dense cache

The reference stacks its layers under one ``lax.scan`` and flattens the
pool to ``[L*(NB+1), ...]`` with ``layer * n_phys`` added to the tables;
eager PyTorch needs neither, so each layer is its own :class:`Block` and
receives its contiguous pool layer ``pool["k"][l]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, require_slice
from repro_torch.device import resolve_device
from repro_torch.kvcache.view import PagedCacheView
from repro_torch.models import attention
from repro_torch.models.layers import (embed_apply, mlp_apply, norm_apply,
                                       unembed_apply)
from repro_torch.models.params import init_params

Tree = Dict[str, object]


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
    """One pre-norm attention block: ``x + attn(ln1(x))``, then
    ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, leaves: Dict[str, Dict]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Leaves(leaves["ln1"])
        self.attn = Leaves(leaves["attn"])
        self.ln2 = Leaves(leaves["ln2"])
        self.ffn = Leaves(leaves["ffn"])

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + mlp_apply(self.ffn.tree(),
                             norm_apply(self.ln2.tree(), x, self.cfg),
                             self.cfg)

    def seq(self, x: torch.Tensor, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h, (k, v) = attention.self_attn_seq(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            self.cfg, positions=positions, causal=self.cfg.causal)
        return self._mlp(x + h), k, v

    def decode(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor,
               lengths: Optional[torch.Tensor]) -> torch.Tensor:
        h = attention.self_attn_decode(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg), k, v,
            self.cfg, pos=pos, lengths=lengths)
        return self._mlp(x + h)

    def decode_paged(self, x: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor,
                     view: PagedCacheView) -> torch.Tensor:
        h = attention.paged_self_attn_decode(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            k_pool, v_pool, self.cfg, tables=view.tables,
            lengths=view.lengths, positions=view.positions,
            block_size=view.block_size)
        return self._mlp(x + h)


class Model(nn.Module):
    """A dense decoder on one device.

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
        require_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, device=self.device)
        to_dev = lambda leaves: {n: t.to(self.device)   # noqa: E731
                                 for n, t in leaves.items()}
        self.embed = Leaves(to_dev(params["embed"]))
        stack = params["stack"][0]
        self.layers = nn.ModuleList(
            Block(cfg, {grp: to_dev({n: t[l] for n, t in leaves.items()})
                        for grp, leaves in stack.items()})
            for l in range(cfg.n_layers))
        self.final_norm = Leaves(to_dev(params["final_norm"]))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """[B,1,D] final hidden -> [B, vocab] float32 logits."""
        x = norm_apply(self.final_norm.tree(), x, self.cfg)
        return unembed_apply(self.embed.tree(), x,
                             self.cfg)[:, 0, :self.cfg.vocab_size]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process a prompt batch ``tokens [B,S]`` (right-padded, valid
        lengths ``lengths [B]``). Returns ``(logits [B, vocab],
        {"k", "v"})``: float32 logits at each request's last valid
        position, and every layer's K/V as ``[L, B, max(S, cache_len),
        K, hd]`` (rows past ``S`` zero)."""
        cfg, dev = self.cfg, self.device
        tokens = torch.as_tensor(tokens, device=dev)
        B, S = tokens.shape
        positions = torch.arange(S, device=dev)
        x = embed_apply(self.embed.tree(), tokens.long(), positions, cfg)
        ks, vs = [], []
        for blk in self.layers:
            x, k, v = blk.seq(x, positions)
            ks.append(k)
            vs.append(v)
        if lengths is not None:
            last = torch.as_tensor(lengths, device=dev).long() - 1
            x = x[torch.arange(B, device=dev), last][:, None]
        else:
            x = x[:, -1:]
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cache_len is not None and cache_len > S:
            pad = (0, 0, 0, 0, 0, cache_len - S)
            cache = {n: torch.nn.functional.pad(c, pad)
                     for n, c in cache.items()}
        return self._logits(x), cache

    def init_cache(self, batch: int, kv_len: int) -> Dict[str, torch.Tensor]:
        """A zeroed dense cache ``{"k", "v"}``, each ``[L, batch, kv_len,
        K, hd]`` in the model's dtype on its device."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads, cfg.hd)
        return {n: torch.zeros(shape, dtype=cfg.activation_dtype,
                               device=self.device) for n in ("k", "v")}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Union[PagedCacheView, Dict[str, torch.Tensor]],
                    pos: Optional[Union[int, torch.Tensor]] = None,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token for every row (``tokens [B]``); returns float32
        logits ``[B, vocab]``.

        With a :class:`PagedCacheView` the positions and lengths come
        from the view, and each layer's new K/V rows go into
        ``view.pool``. With a dense cache ``{"k", "v": [L, B, S, K,
        hd]}`` (from :meth:`prefill` or :meth:`init_cache`) ``pos`` is
        one position for the batch or a ``[B]`` tensor, ``lengths`` the
        optional ``[B]`` valid lengths (see
        :func:`~repro_torch.models.attention.self_attn_decode`), and the
        cache is **updated in place**, where the reference returns a new
        one.
        """
        if isinstance(cache, PagedCacheView):
            pos_t = cache.positions.long()[:, None]
            x = embed_apply(self.embed.tree(), tokens.long()[:, None], pos_t,
                            self.cfg)
            for l, blk in enumerate(self.layers):
                x = blk.decode_paged(x, cache.pool["k"][l],
                                     cache.pool["v"][l], cache)
            return self._logits(x)
        if pos is None:
            raise ValueError("decode_step on a dense cache needs pos")
        pos = torch.as_tensor(pos, device=self.device)
        emb_pos = pos.long()[:, None] if pos.dim() else pos.long().reshape(1)
        x = embed_apply(self.embed.tree(), tokens.long()[:, None], emb_pos,
                        self.cfg)
        for l, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][l], cache["v"][l], pos, lengths)
        return self._logits(x)
