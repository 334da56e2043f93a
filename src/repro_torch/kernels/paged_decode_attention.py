"""Paged GQA decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``repro.kernels.paged_decode_attention``. The kernel
(``csrc/paged_decode_attention.cu``) follows each request's block table
into the physical pool, so the pool is never gathered into a dense
``[B, S, K, hd]`` copy. :func:`paged_gqa_decode_attention` launches it for
CUDA tensors (or raises) and runs :func:`paged_gqa_decode_attention_torch`
for CPU tensors; nothing falls back from the one to the other.

Layout: ``q [B,H,hd]``; ``k_pool/v_pool [NB,BS,K,hd]`` (one layer of the
pool, contiguous); ``block_table [B,nb]`` int32; ``lengths [B]`` int32
-> ``[B,H,hd]`` in ``q.dtype``. A row reads its first
``min(ceil(length/BS), nb)`` table entries, which must be valid block ids;
a length-0 row (batch padding) gives exact zeros.

The kernel splits the table's capacity ``nb * BS`` as the contiguous
kernel splits its cache (:func:`paged_split_plan`, whole blocks a split),
each live split writes its unnormalised ``(acc, m, l)`` to an f32
scratch, and a second kernel merges them.
:func:`paged_split_partials_torch` and :func:`paged_merge_partials_torch`
are that arithmetic in plain PyTorch, for the CPU tests.

Two more entries carry a decode over a KV sequence sharded on the model
axis (each rank holds some rows of every block):
:func:`paged_decode_partials` runs the split kernel over the rank's rows
and writes each row's and head's unnormalised ``(acc, m, l)`` as ``[B,
H, hd + 2]`` float32 (``m = -inf``, ``l = 0``, ``acc = 0`` where the rank
holds no live row), and :func:`paged_decode_combine` takes ``M`` such
partials ``[M, B, H, hd + 2]`` to the output ``[B, H, hd]``, exact zeros
where no piece holds a row. :func:`paged_decode_partials_torch` and
:func:`paged_decode_combine_torch` are their plain versions, run on CPU
tensors only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import (KernelCost, count_launch,
                                          counted_kernel)
from repro_torch.kernels.decode_attention import (
    KERNEL_HEAD_DIMS, MAX_GROUP, SplitPlan, merge_live_splits_torch,
    split_partial_torch, split_plan)

NAME = "paged_decode_attention"
NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gqa_decode_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_table: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: a loop over logical blocks, each gathering one
    ``[B, BS, K, hd]`` tile through the table, with an f32 online softmax
    (counterpart of ``paged_gqa_decode_attention_jax``)."""
    acc, _, l = _online_state(q, k_pool, v_pool, block_table, lengths)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def paged_decode_partials_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_table: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """The partials entry's plain version: the online softmax's
    unnormalised ``(acc, m, l)`` over each row's first ``lengths`` rows,
    ``[B, H, hd + 2]`` float32 (``m = -inf``, ``l = 0``, ``acc = 0`` for
    a length-0 row)."""
    B, H, hd = q.shape
    acc, m, l = _online_state(q, k_pool, v_pool, block_table, lengths)
    m = torch.where(l > 0, m, float("-inf"))
    return torch.cat([acc.reshape(B, H, hd), m.reshape(B, H, 1),
                      l.reshape(B, H, 1)], -1)


def paged_decode_combine_torch(parts: torch.Tensor,
                               dtype: torch.dtype) -> torch.Tensor:
    """The combine's plain version: ``parts [M, B, H, hd + 2]`` to ``[B,
    H, hd]`` in ``dtype``, each piece that holds rows (``l > 0``) weighed
    by ``e^(m - max m)``; exact zeros where none does."""
    acc, m, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    live = l > 0
    mx = torch.where(live, m, float("-inf")).amax(0)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    a = (w[..., None] * acc).sum(0)
    return (a / (w * l).sum(0).clamp_min(1e-30)[..., None]).to(dtype)


def _online_state(q, k_pool, v_pool, block_table, lengths):
    """The plain version's f32 online softmax over the table's blocks:
    ``(acc [B,K,G,hd], m [B,K,G], l [B,K,G])``, unnormalised."""
    B, H, hd = q.shape
    NB, BS, K, _ = k_pool.shape
    nb = block_table.shape[1]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    tbl = block_table.long()
    lens = lengths.long()
    m = torch.full((B, K, G), NEG_INF, device=q.device)
    l = torch.zeros((B, K, G), device=q.device)
    acc = torch.zeros((B, K, G, hd), device=q.device)
    for i in range(nb):
        kb = k_pool[tbl[:, i]].float()                   # [B,BS,K,hd]
        vb = v_pool[tbl[:, i]].float()
        s = torch.einsum("bkgh,bskh->bkgs", qg, kb) * hd ** -0.5
        ids = i * BS + torch.arange(BS, device=q.device)
        valid = (ids[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # explicit zero so a length-0 row (s == m_new == NEG_INF) adds
        # nothing and outputs zeros
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bskh->bkgh", p, vb)
        m = m_new
    return acc, m, l


@functools.cache
def paged_split_plan(B: int, nb: int, BS: int, K: int, G: int,
                     hd: int) -> SplitPlan:
    """The contiguous kernel's plan (:func:`split_plan`) over the table's
    capacity ``nb * BS`` rows, each split rounded up to whole ``BS``-row
    blocks; from the shapes alone (the lengths stay on the device), and
    cached, so a decode step's calls compute it once a shape."""
    if min(B, nb, BS, K, G, hd) < 1:
        raise ValueError(f"no paged split plan for B={B} nb={nb} BS={BS} "
                         f"K={K} G={G} hd={hd}")
    S = nb * BS
    rows = -(-split_plan(B, S, K, G, hd).rows_per_split // BS) * BS
    n = -(-S // rows)
    return SplitPlan(n, rows, (B, K, n, G, hd + 2))


def _bound(lengths: torch.Tensor, nb: int, BS: int) -> torch.Tensor:
    """Rows each request reads: its length, within ``[0, nb * BS]``."""
    return lengths.long().clamp(0, nb * BS)


def paged_split_partials_torch(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               lengths: torch.Tensor,
                               plan: SplitPlan) -> torch.Tensor:
    """What the split kernel writes, split by split: for each (request,
    KV head, split, head) the unnormalised ``acc`` over the split's rows,
    read block by block through the table, and its ``m`` and ``l``, as
    ``[..., hd + 2]`` f32. A split wholly past a row's bound (every split
    of a length-0 row) is not written: NaN here. No table entry past
    ``min(ceil(length/BS), nb)`` is read."""
    B, H, hd = q.shape
    _, BS, K, _ = k_pool.shape
    nb = block_table.shape[1]
    G = H // K
    if plan.rows_per_split % BS:
        raise ValueError(f"a split of {plan.rows_per_split} rows is not "
                         f"whole {BS}-row blocks")
    n_tok = _bound(lengths, nb, BS)
    qg = q.reshape(B, K, G, hd).float()
    part = torch.full(plan.scratch_shape, float("nan"))
    for b in range(B):
        for s in range(plan.n_split):
            r0 = s * plan.rows_per_split
            r1 = min(r0 + plan.rows_per_split, int(n_tok[b]))
            if r0 >= r1:
                continue
            ids = block_table[b, r0 // BS:-(-r1 // BS)].long()
            kc = k_pool[ids].reshape(-1, K, hd)[:r1 - r0].float()
            vc = v_pool[ids].reshape(-1, K, hd)[:r1 - r0].float()
            part[b, :, s] = split_partial_torch(qg[b], kc, vc)
    return part


def paged_merge_partials_torch(part: torch.Tensor, lengths: torch.Tensor,
                               nb: int, BS: int,
                               plan: SplitPlan) -> torch.Tensor:
    """The merge kernel: each row's live splits,
    ``ceil(min(length, nb*BS) / rows_per_split)`` of them, merged; zeros
    where there are none. Returns ``[B, H, hd]`` f32."""
    B, K, n, G, hd2 = part.shape
    live = (torch.arange(n)[None, :] * plan.rows_per_split
            < _bound(lengths, nb, BS)[:, None])
    return merge_live_splits_torch(part, live).reshape(B, K * G, hd2 - 2)


@functools.cache
def _entry(symbol: str = NAME):
    lib = _build.library(NAME)
    fn = getattr(lib, symbol)
    if symbol == "paged_decode_combine":
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_args(q, k_pool, v_pool, block_table, lengths):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [B,H,hd] and k_pool [NB,BS,K,hd], got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, H, hd = q.shape
    NB, BS, K, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)} do not match")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_table must be [B,nb] with nb >= 1 and "
                         f"lengths [B] for B={B}, got "
                         f"{tuple(block_table.shape)} and "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and equal, "
                        f"got q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    G = H // K
    if hd not in KERNEL_HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"unsupported head shape: G={G}, hd={hd} "
                         f"(need G <= {MAX_GROUP}, hd in {KERNEL_HEAD_DIMS})")
    ts = (q, k_pool, v_pool, block_table, lengths)
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous (pass k_pool[l], a "
                         "contiguous layer of the pool)")
    # the kernel reads q and each pool row in 16-byte pieces
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q, k_pool and v_pool must be 16-byte aligned")


def paged_cost(q: torch.Tensor, k_pool: torch.Tensor,
               v_pool: torch.Tensor, block_table: torch.Tensor,
               lengths: torch.Tensor) -> KernelCost:
    """One launch at these shapes, lengths unread: every K/V row the table
    can address (``B * nb * BS``) read once, ``4 H hd`` FLOPs a row; q,
    the output, the table and the lengths once; the split scratch."""
    B, H, hd = q.shape
    _, BS, K, _ = k_pool.shape
    nb = block_table.shape[1]
    rows = B * nb * BS
    scratch = 0
    if B:
        plan = paged_split_plan(B, nb, BS, K, H // K, hd)
        scratch = 4 * _numel(plan.scratch_shape)
    return KernelCost(
        flops=4.0 * rows * H * hd,
        bytes=float(2 * rows * K * hd * k_pool.element_size()
                    + 2 * q.numel() * q.element_size()
                    + 4 * (block_table.numel() + lengths.numel())),
        scratch=float(scratch))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@counted_kernel("paged_decode_attention", paged_cost)
def paged_gqa_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Block-table decode attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, an output with no work for meta
    tensors."""
    if q.device.type == "cpu":
        return paged_gqa_decode_attention_torch(q, k_pool, v_pool,
                                                block_table, lengths)
    out = torch.empty_like(q)
    if _launch(NAME, q, k_pool, v_pool, block_table, lengths, out):
        count_launch(paged_gqa_decode_attention)
    return out


def _launch(symbol: str, q, k_pool, v_pool, block_table, lengths,
            out) -> bool:
    """Launch the split kernel and the merge of ``symbol`` (the output or
    the partials into ``out``) on a CUDA tensor; False where there is no
    work (a meta tensor, an empty batch)."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k_pool, v_pool, block_table, lengths)
    B, H, hd = q.shape
    _, BS, K, _ = k_pool.shape
    nb = block_table.shape[1]
    if B == 0 or q.device.type == "meta":
        return False
    plan = paged_split_plan(B, nb, BS, K, H // K, hd)
    part = torch.empty(plan.scratch_shape, dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry(symbol)(q.data_ptr(), k_pool.data_ptr(),
                            v_pool.data_ptr(), block_table.data_ptr(),
                            lengths.data_ptr(), out.data_ptr(),
                            part.data_ptr(), B, K, H // K, hd, BS, nb,
                            plan.n_split, plan.rows_per_split,
                            _DTYPES[q.dtype],
                            torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    return True


def partials_cost(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, block_table: torch.Tensor,
                  lengths: torch.Tensor) -> KernelCost:
    """:func:`paged_cost` with the float32 partials ``[B, H, hd + 2]``
    written in place of the output."""
    c = paged_cost(q, k_pool, v_pool, block_table, lengths)
    B, H, hd = q.shape
    return dataclasses.replace(
        c, bytes=c.bytes - q.numel() * q.element_size()
        + 4 * B * H * (hd + 2))


@counted_kernel("paged_decode_partials", partials_cost)
def paged_decode_partials(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The partials entry: each row's and head's unnormalised ``(acc, m,
    l)`` over its first ``lengths`` rows, ``[B, H, hd + 2]`` float32 (the
    split kernel and a merge that does not normalise, for CUDA tensors;
    the plain version for CPU tensors)."""
    if q.device.type == "cpu":
        return paged_decode_partials_torch(q, k_pool, v_pool, block_table,
                                           lengths)
    B, H, hd = q.shape
    out = torch.empty((B, H, hd + 2), dtype=torch.float32, device=q.device)
    if _launch("paged_decode_partials", q, k_pool, v_pool, block_table,
               lengths, out):
        count_launch(paged_decode_partials)
    return out


def combine_cost(parts: torch.Tensor, dtype: torch.dtype) -> KernelCost:
    """One combine: the partials read once (each piece's ``m`` and ``l``
    twice), the output written once; ``4 M`` operations an element."""
    M, B, H, hd2 = parts.shape
    isz = torch.empty((), dtype=dtype).element_size()
    return KernelCost(flops=4.0 * M * B * H * (hd2 - 2),
                      bytes=float(4 * parts.numel() + 8 * M * B * H
                                  + B * H * (hd2 - 2) * isz))


@counted_kernel("paged_decode_combine", combine_cost)
def paged_decode_combine(parts: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """``M`` pieces' partials ``[M, B, H, hd + 2]`` float32 to the output
    ``[B, H, hd]`` in ``dtype``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, an output with no work for meta
    tensors."""
    if parts.device.type == "cpu":
        return paged_decode_combine_torch(parts, dtype)
    if parts.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {parts.device}")
    if parts.dim() != 4 or parts.dtype != torch.float32 or \
            not parts.is_contiguous() or dtype not in _DTYPES:
        raise ValueError(f"parts must be contiguous float32 [M,B,H,hd+2] "
                         f"and dtype float32/bfloat16, got "
                         f"{tuple(parts.shape)} {parts.dtype}, {dtype}")
    M, B, H, hd2 = parts.shape
    out = torch.empty((B, H, hd2 - 2), dtype=dtype, device=parts.device)
    if B * H == 0 or parts.device.type == "meta":
        return out
    with torch.cuda.device(parts.device):
        rc = _entry("paged_decode_combine")(
            parts.data_ptr(), out.data_ptr(), M, B * H, hd2 - 2,
            _DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    count_launch(paged_decode_combine)
    return out


# kernel launches since the last reset (counted only where the kernel runs;
# one a call, the split kernel and its merge together)
paged_gqa_decode_attention.launches = 0
paged_decode_partials.launches = 0
paged_decode_combine.launches = 0
