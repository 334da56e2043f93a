"""Every family of the registry as an ``nn.Module`` (counterpart of
``repro.models.model``): dense (causal, optionally with a sliding
window), the bidirectional encoder, the VLM (a cross-attention block
every ``cross_every`` layers over a request's image K/V), MoE, SSM
(Mamba2) and hybrid (Mamba2 with one shared attention block every
``attn_every`` layers).

Public entry points:
  forward      — full-sequence logits (token ids, or embeddings for a
                 config with ``embedding_inputs``; the encoder's entry)
  train_forward, loss
               — the reference's ``forward`` and ``loss``, differentiable
                 (each period of the stack rematerialised); the gradients
                 land on ``params``, the reference-layout tree
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
of its own and receives its contiguous pool layer. Its weights are views
of the stacked leaves of ``Model.params`` (the reference's layout, and
the model's registered parameters), so an optimizer step on those
leaves, made in place, is what every entry point reads next.

An MoE block routes at the config's ``moe.capacity_factor`` in a
prefill and at ``serve_capacity_factor`` in a decode step, over every
row it is given, batch padding included, as the reference does.

Over a mesh (``Model(cfg, params, mesh=..., rules=...)``, in a process
that joined it: :mod:`repro_torch.distributed`) the model holds one
rank's block of every weight under the rules (the ``act_replicated``
ones by default), and ``forward``, ``prefill`` and ``decode_step`` run
with the mesh's group and the rank's plan
(:func:`~repro_torch.sharding.layout_for`) active, so the layers'
collectives keep the residual stream in its layout (replicated, or the
rank's block of d_model) and the logits replicated on every rank; each
rank holds the cache of its KV heads, or, over a sharded KV sequence,
its share of every block's rows. Over a data axis of D devices
(``D x M``, any rules ``rules_for`` gives) each entry point takes the
data rank's own rows (the engine's steps hand each rank its block of the
batch); under ``fsdp`` each rank holds its data block of every weight's
``W_IN`` dim and each layer gathers them whole just before its matmuls.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import CROSS, SHARED_ATTN, SSM, ArchConfig
from repro_torch.core.analysis import scope
from repro_torch.device import on_device, resolve_device
from repro_torch.kvcache.view import PagedCacheView
from repro_torch.models import attention
from repro_torch.models.layers import (decode_embed, embed_inputs,
                                       mlp_apply, norm_apply, unembed_apply)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (cache_layers, init_params,
                                       init_shard, layer_sources, map_tree,
                                       param_specs, parameter_tree,
                                       plan_structure, rank_layout,
                                       state_leaves, tree_leaves)
from repro_torch.models.ssm import ssm_decode, ssm_seq
from repro_torch.sharding import check_executable, rules_for, shard_tree

Tree = Dict[str, object]
Cache = Dict[str, torch.Tensor]


def _on_mesh(fn):
    """Run a model entry point with the model's mesh group active (its
    layers' collectives then run); a model on one device runs as is."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        if self.group is None:
            return fn(self, *args, **kwargs)
        with self.group.active(self.layout):
            return fn(self, *args, **kwargs)
    return call


class Leaves:
    """One parameter group of a layer (e.g. ``attn``), handed to the layer
    functions as a dict: views of the model's reference-layout leaves,
    ``leaf[rep]`` for a stacked layer, the leaf itself otherwise. With
    gradients on, each call takes the views afresh, so autograd carries
    a layer's gradient to the stacked leaf (and a hybrid's shared block,
    read by several layers, sums its gradients there); without, it hands
    out views taken once, which see every in-place update of the
    leaves."""

    def __init__(self, leaves: Dict[str, torch.Tensor],
                 rep: Optional[int] = None):
        self._leaves, self._rep = leaves, rep
        with torch.no_grad():
            self._views = self._take()

    def _take(self) -> Dict[str, torch.Tensor]:
        r = self._rep
        return {n: t if r is None else t[r] for n, t in self._leaves.items()}

    def tree(self) -> Dict[str, torch.Tensor]:
        return self._take() if torch.is_grad_enabled() else dict(self._views)


class Block(nn.Module):
    """One pre-norm attention block: ``x + attn(ln1(x))``, then ``x +
    ffn(ln2(x))``, the FFN dense or (``moe``) routed."""

    def __init__(self, cfg: ArchConfig, leaves: Dict[str, Dict],
                 rep: Optional[int] = None, moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.moe = moe
        self.ln1 = Leaves(leaves["ln1"], rep)
        self.attn = Leaves(leaves["attn"], rep)
        self.ln2 = Leaves(leaves["ln2"], rep)
        ffn = dict(leaves["ffn"])
        dense = ffn.pop("dense", None)
        self.ffn = Leaves(ffn, rep)
        self.dense = Leaves(dense, rep) if dense is not None else None

    def _ffn(self, x: torch.Tensor, capacity_factor: float,
             aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """``x + ffn(ln2(x))``; an MoE block given an ``aux`` list
        appends its load-balance loss to it."""
        h = norm_apply(self.ln2.tree(), x, self.cfg)
        if not self.moe:
            return x + mlp_apply(self.ffn.tree(), h, self.cfg)
        p = self.ffn.tree()
        if self.dense is not None:
            p["dense"] = self.dense.tree()
        if aux is None:
            return x + moe_ffn(p, h, self.cfg,
                               capacity_factor=capacity_factor)
        out, a = moe_ffn(p, h, self.cfg, capacity_factor=capacity_factor,
                         with_aux=True)
        aux.append(a)
        return x + out

    def seq(self, x: torch.Tensor, positions: torch.Tensor,
            lengths: Optional[torch.Tensor],
            prefix: Optional[Tuple[torch.Tensor, torch.Tensor]],
            prefix_len: Union[int, torch.Tensor],
            img_embeds: Optional[torch.Tensor] = None,
            aux: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Cache]:
        pk, pv = prefix if prefix is not None else (None, None)
        h, (k, v) = attention.self_attn_seq(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            self.cfg, positions=positions, causal=self.cfg.causal,
            window=self.cfg.sliding_window, lengths=lengths, prefix_k=pk,
            prefix_v=pv, prefix_len=prefix_len)
        cf = self.cfg.moe.capacity_factor if self.moe else 1.0
        return self._ffn(x + h, cf, aux), {"k": k, "v": v}

    def decode(self, x: torch.Tensor, entry: Cache, pos: torch.Tensor,
               lengths: Optional[torch.Tensor],
               block_size: Optional[int] = None) -> torch.Tensor:
        h = attention.self_attn_decode(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            entry["k"], entry["v"], self.cfg, pos=pos,
            window=self.cfg.sliding_window, lengths=lengths,
            block_size=block_size)
        return self._ffn(x + h, self.cfg.serve_capacity_factor)

    def decode_paged(self, x: torch.Tensor, entry: Cache,
                     view: PagedCacheView) -> torch.Tensor:
        h = attention.paged_self_attn_decode(
            self.attn.tree(), norm_apply(self.ln1.tree(), x, self.cfg),
            entry["k"], entry["v"], self.cfg, tables=view.tables,
            lengths=view.lengths, positions=view.positions,
            block_size=view.block_size, seq_lengths=view.seq_lengths)
        return self._ffn(x + h, self.cfg.serve_capacity_factor)


class CrossBlock(Block):
    """One pre-norm cross-attention block (a VLM's ``CROSS`` layer): ``x
    + cross_attn(ln1(x))`` onto the request's image K/V, then ``x +
    mlp(ln2(x))``. A prefill projects the image embeddings to its K/V
    and returns them as the layer's entry ``{"xk", "xv"}``; a decode step
    reads them from the dense cache or, paged, from the pool's slots."""

    def seq(self, x: torch.Tensor, positions: torch.Tensor,
            lengths: Optional[torch.Tensor], prefix, prefix_len,
            img_embeds: Optional[torch.Tensor] = None, aux=None
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
               lengths=None, block_size=None) -> torch.Tensor:
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

    def __init__(self, cfg: ArchConfig, leaves: Dict[str, Dict],
                 rep: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Leaves(leaves["ln1"], rep)
        self.ssm = Leaves(leaves["ssm"], rep)

    def seq(self, x: torch.Tensor, positions: torch.Tensor,
            lengths: Optional[torch.Tensor], prefix, prefix_len,
            img_embeds=None, aux=None) -> Tuple[torch.Tensor, Cache]:
        if prefix is not None:
            raise NotImplementedError("prefix KV reuse over SSM state")
        h, state = ssm_seq(self.ssm.tree(),
                           norm_apply(self.ln1.tree(), x, self.cfg), self.cfg)
        return x + h, state

    def decode(self, x: torch.Tensor, entry: Cache, pos=None,
               lengths=None, block_size=None) -> torch.Tensor:
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
    """A model of any family of the registry on one device, or one rank's
    shard of a dense decoder over a mesh.

    ``params`` is a tree in the reference's layout (from
    :func:`~repro_torch.models.params.init_params` or
    :func:`~repro_torch.models.params.params_from_numpy`); without it the
    weights are drawn from ``generator`` (seed 0 by default) on the
    device. ``device=None`` means the card, and raises without one.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) and
    ``group`` (this process's place on it,
    :meth:`repro_torch.distributed.MeshGroup.init`) the model is the
    group's rank of it, on the rank's device, under ``rules``
    (``rules_for(mesh, act_replicated=True)`` by default; any rules
    ``rules_for`` gives run, FSDP included): ``params``, whole or already
    the rank's blocks, are cut to its blocks (``layout.cut``); drawn, each
    leaf is drawn whole as the one-device model draws it and cut
    (:func:`~repro_torch.models.params.init_shard`), so the weights are
    the one-device model's, seed for seed. ``layout`` is the rank's plan
    (:class:`~repro_torch.sharding.Layout`). What the mesh does not run
    raises (:func:`~repro_torch.sharding.check_executable`).
    """

    def __init__(self, cfg: ArchConfig, params: Optional[Tree] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 mesh=None, rules=None, group=None):
        super().__init__()
        self.cfg = cfg
        self.group = None
        self.rules = None
        self.layout = None
        if mesh is not None:
            rules = rules or rules_for(mesh, act_replicated=True)
            check_executable(cfg, rules)
            if group is None or group.mesh.shape != mesh.shape or \
                    list(group.mesh.devices.flat) != list(mesh.devices.flat):
                raise RuntimeError("this process has not joined the mesh: "
                                   "pass the group MeshGroup.init (or "
                                   "distributed.spawn) gave it")
            if device is not None and \
                    resolve_device(device) != group.device:
                raise ValueError(f"rank {group.rank} runs on "
                                 f"{group.device}, not {device}")
            device = group.device
            self.group, self.rules = group, rules
            self.layout = rank_layout(cfg, rules, group.rank)
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            if self.group is not None:
                params = init_shard(cfg, generator, self.rules,
                                    self.group.rank, device=self.device)
            else:
                params = init_params(cfg, generator, device=self.device)
        elif self.group is not None:
            params = shard_tree(param_specs(cfg), params, self.rules,
                                self.group.rank, self.layout)

        # the reference-layout tree, each leaf a parameter registered under
        # its flat checkpoint key; the layers read views of it
        self.params = parameter_tree(
            map_tree(lambda t: t.to(self.device), params))
        for key, leaf in tree_leaves(self.params):
            self.register_parameter(key, leaf)
        params = self.params
        self.embed = Leaves(params["embed"])
        self.shared = Block(cfg, params["shared"]) \
            if "shared" in params else None
        layers: List[nn.Module] = []
        for kind, (where, i, rep) in zip(cfg.block_plan(),
                                          layer_sources(cfg)):
            if kind == SHARED_ATTN:
                layers.append(self.shared)
                continue
            leaves = params[where][i]
            if kind == SSM:
                layers.append(SSMBlock(cfg, leaves, rep))
            elif kind == CROSS:
                layers.append(CrossBlock(cfg, leaves, rep))
            else:
                layers.append(Block(cfg, leaves, rep,
                                    moe=cfg.moe is not None))
        self.layers = nn.ModuleList(layers)
        self.final_norm = Leaves(params["final_norm"])
        # the query heads this device's projection yields and the KV heads
        # it holds (all of them on one device)
        lay = self.layout
        self.n_heads = cfg.n_heads if lay is None else \
            lay.heads[1] - lay.heads[0]
        self.n_kv_heads = cfg.n_kv_heads if lay is None else \
            lay.kv_heads[1] - lay.kv_heads[0]
        # the training forward's units, in plan order: each period of the
        # stack (rematerialised as one), then each remainder block
        slots, n_rep, rem = plan_structure(cfg)
        p = len(slots)
        self._periods = [(True, tuple(range(r * p, (r + 1) * p)))
                         for r in range(n_rep)] + \
            [(False, (n_rep * p + i,)) for i in range(rem)]
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

    @property
    def data(self) -> int:
        """The data ranks the batch rows are split over (1 on one
        device)."""
        return 1 if self.layout is None else self.layout.data

    @property
    def seq_shard(self) -> Optional[Tuple[int, int]]:
        """``(rank, M)`` where the KV sequence is sharded on the model
        axis (the pool's ``seq_shard``), else None."""
        lay = self.layout
        return (lay.rank, lay.size) if lay is not None and lay.kv_seq \
            else None

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
                   img_embeds: Optional[torch.Tensor],
                   block_size: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Cache]:
        """Every layer over a whole sequence: the last hidden rows (before
        the final norm) and each layer's cache entry, stacked by key. Over
        a sharded KV sequence each layer's prefix (the rank's rows of each
        ``block_size`` block) is made whole just before the layer runs."""
        seq = prefix is not None and self.seq_shard is not None
        if seq and block_size is None:
            raise ValueError("a prefix over a sharded KV sequence needs "
                             "its block_size")
        if img_embeds is not None:
            img_embeds = on_device(img_embeds, self.device)
        parts: Dict[str, List[torch.Tensor]] = {}
        for l, blk in enumerate(self.layers):
            # an SSM layer's prefix is () (the prefix holds no state): it
            # refuses it, as the reference does
            keys, i = self._entries[l]
            pkv = None if prefix is None else tuple(
                prefix[n][i] for n in keys if n in prefix)
            if seq and pkv:
                pkv = attention.whole_prefix(*pkv, block_size)
            x, entry = blk.seq(x, positions, lengths, pkv, prefix_len,
                               img_embeds=img_embeds)
            for name, t in entry.items():
                parts.setdefault(name, []).append(t)
        return x, {name: torch.stack(ts) for name, ts in parts.items()}

    @torch.no_grad()
    @_on_mesh
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

    def _train_layers(self, x: torch.Tensor, layers: Tuple[int, ...],
                      positions: torch.Tensor,
                      lengths: Optional[torch.Tensor],
                      img_embeds: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layers ``layers`` over a whole sequence: the hidden rows and the
        sum of their MoE load-balance losses (float32)."""
        aux: List[torch.Tensor] = []
        for l in layers:
            x, _ = self.layers[l].seq(x, positions, lengths, None, 0,
                                      img_embeds=img_embeds, aux=aux)
        total = torch.stack(aux).sum() if aux else torch.zeros(
            (), dtype=torch.float32, device=x.device)
        return x, total

    def train_forward(self, batch: Dict[str, object]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward``, differentiable: ``(logits [B, S,
        vocab] float32, aux)``, ``aux`` the MoE blocks' load-balance loss
        (0 without MoE). ``batch`` holds ``tokens [B,S]`` (or ``embeds
        [B,S,D]`` for a config with ``embedding_inputs``), optionally
        ``lengths [B]``, and a VLM's ``img_embeds [B, n_img, D]``; numpy
        arrays or tensors. Each period of the stack runs under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
        around its scan body): its input is kept and its insides are
        recomputed in the backward. MoE blocks route at
        ``moe.capacity_factor``, the training capacity. A model over a
        mesh of more than one device raises."""
        if self.group is not None and self.group.mesh.size > 1:
            from repro_torch.launch.mesh import multi_card_item
            raise NotImplementedError(
                f"training over {self.group.mesh.size} devices "
                f"({multi_card_item('train')})")
        dev = self.device
        x, positions = self._embed_seq(batch.get("tokens"),
                                       batch.get("embeds"))
        lengths = batch.get("lengths")
        if lengths is not None:
            lengths = on_device(lengths, dev).to(torch.int32)
        img = batch.get("img_embeds")
        if img is not None:
            img = on_device(img, dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for stacked, layers in self._periods:
            if stacked:
                x, a = checkpoint(self._train_layers, x, layers, positions,
                                  lengths, img, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._train_layers(x, layers, positions, lengths, img)
            aux = aux + a
        x = norm_apply(self.final_norm.tree(), x, self.cfg)
        logits = unembed_apply(self.embed.tree(), x, self.cfg)
        return logits[..., :self.cfg.vocab_size], aux

    def loss(self, batch: Dict[str, object]) -> torch.Tensor:
        """The reference's ``loss``, differentiable: next-token (or frame)
        cross-entropy, logsumexp minus the label's logit, averaged over
        the labels ``>= 0`` (at least 1), plus the load-balance loss.
        ``batch["labels"] [B, S]`` beside :meth:`train_forward`'s
        inputs."""
        logits, aux = self.train_forward(batch)
        labels = on_device(batch["labels"], self.device).long()
        valid = labels >= 0
        labs = torch.where(valid, labels, 0)
        with scope("loss"):
            picked = logits.gather(-1, labs[..., None])
            ce = torch.where(valid, torch.logsumexp(logits, dim=-1)
                             - picked[..., 0], 0.0)
            return ce.sum() / valid.sum().clamp_min(1) + aux

    @torch.no_grad()
    @_on_mesh
    def prefill(self, tokens: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None,
                prefix: Optional[Cache] = None,
                prefix_len: Union[int, torch.Tensor] = 0, *,
                embeds: Optional[torch.Tensor] = None,
                img_embeds: Optional[torch.Tensor] = None,
                own_rows: bool = True,
                block_size: Optional[int] = None
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
        tensor back to the host.

        Over a KV sequence sharded on the model axis the dense cache holds
        the rank's contiguous share of its slots (the reference's cache
        spec); ``own_rows=False`` returns every row instead (a paged pool
        then writes each to the rank that holds it). There ``prefix``
        holds the rank's rows of each ``block_size`` block (a pool's dense
        copy, :meth:`~repro_torch.kvcache.paged.PagedKVCache.
        gather_tables`): each layer all-gathers every rank's rows of it
        (:func:`~repro_torch.models.attention.whole_prefix`)."""
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
                                   prefix_len, img_embeds, block_size)
        if lengths is not None:
            last = lengths.long() - 1
            x = x[torch.arange(B, device=dev), last][:, None]
        else:
            x = x[:, -1:]
        for name in ("k", "v"):
            if name in cache:
                cache[name] = self._finalize(cache[name], S, cache_len)
                if own_rows and self.layout is not None and \
                        self.layout.kv_seq:
                    a, b = self._seq_block(cache[name].shape[2])
                    cache[name] = cache[name][:, :, a:b].contiguous()
        return self._logits(x), cache

    def _seq_block(self, slots: int) -> Tuple[int, int]:
        """``[first, end)`` of the rank's share of a dense cache's
        ``slots`` (a KV sequence sharded on the model axis)."""
        if slots % self.layout.size:
            raise ValueError(f"a cache of {slots} slots does not divide over "
                             f"{self.layout.size} ranks")
        return self.layout.block(slots)

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
        if self.layout is not None and self.layout.kv_seq:
            a, b = self._seq_block(kv_len)
            kv_len = b - a
        out = {}
        n_kv = len(cache_layers(cfg)["kv"])
        if n_kv:
            shape = (n_kv, batch, kv_len, self.n_kv_heads, cfg.hd)
            out = {name: torch.zeros(shape, dtype=cfg.activation_dtype,
                                     device=dev) for name in ("k", "v")}
        for name, (shape, dtype) in state_leaves(cfg, batch).items():
            out[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return out

    @torch.no_grad()
    @_on_mesh
    def decode_step(self, tokens: Optional[torch.Tensor],
                    cache: Union[PagedCacheView, Cache],
                    pos: Optional[Union[int, torch.Tensor]] = None,
                    lengths: Optional[torch.Tensor] = None, *,
                    embeds: Optional[torch.Tensor] = None,
                    block_size: Optional[int] = None) -> torch.Tensor:
        """One token for every row (``tokens [B]``, or ``embeds [B,1,D]``
        taken as they are); returns float32 logits ``[B, vocab]``.

        With a :class:`PagedCacheView` the positions, lengths and state
        slots come from the view, and each layer's new K/V rows and new
        state go into ``view.pool``. With a dense cache (from
        :meth:`prefill` or :meth:`init_cache`) ``pos`` is one position
        for the batch or a ``[B]`` tensor, ``lengths`` the optional
        ``[B]`` valid lengths (see
        :func:`~repro_torch.models.attention.self_attn_decode`, which also
        says what ``block_size`` means over a sharded KV sequence), and
        the cache is **updated in place**, where the reference returns a
        new one.
        """
        if isinstance(cache, PagedCacheView):
            lay = self.layout
            if lay is not None and lay.kv_seq and cache.seq_lengths is None:
                # the rank's valid rows, once a step for every layer
                cache = dataclasses.replace(
                    cache, seq_lengths=attention.local_lengths(
                        cache.lengths, cache.block_size,
                        cache.pool["k"].shape[2], lay.rank))
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
            x = blk.decode(x, self._entry(cache, l), pos, lengths,
                           block_size)
        return self._logits(x)
