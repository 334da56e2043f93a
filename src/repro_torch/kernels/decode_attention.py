"""Contiguous-cache GQA decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``repro.kernels.decode_attention``. The kernel
(``csrc/decode_attention.cu``) reads each request's dense ``[S, K, hd]``
cache in place through its strides, up to the request's length.
:func:`gqa_decode_attention` launches it for CUDA tensors (or raises) and
runs :func:`gqa_decode_attention_torch` for CPU tensors; nothing falls back
from the one to the other.

Layout: ``q [B,H,hd]``; ``k/v [B,S,K,hd]`` (last dimension contiguous);
``lengths [B]`` int32, each in ``[0, S]`` -> ``[B,H,hd]`` in ``q.dtype``.
A length-0 row gives what the TPU kernel gives, ``sum_{j<S} V[j] / Sp``
with ``Sp = ceil(S/bs)*bs`` and ``bs = min(block_s, S)`` (it never skips a
tile, so every padded slot of a fully masked row weighs 1); ``block_s``
matters for nothing else.

The kernel splits the sequence (flash-decoding): :func:`split_plan` picks
the number of splits from the shapes alone, each split writes its
unnormalised ``(acc, m, l)`` to an f32 scratch, and a second kernel merges
them. :func:`split_partials_torch` and :func:`merge_partials_torch` are
that arithmetic in plain PyTorch, for the CPU tests.

A second entry carries a decode over a KV sequence sharded on the model
axis (each rank holds some rows of every request's cache):
:func:`decode_partials` runs the split kernel over the rank's rows and
writes each row's and head's unnormalised ``(acc, m, l)`` as ``[B, H,
hd + 2]`` float32, the pieces that
:func:`~repro_torch.kernels.paged_decode_attention.paged_decode_combine`
takes from every rank to the output. A length-0 row is an empty piece
(``acc = 0``, ``m = -inf``, ``l = 0``), not the quirk above: over a
sharded sequence a rank holding no row of a request is common, and the
combine then gives the exact answer. :func:`decode_partials_torch` is its
plain version, run on CPU tensors only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.launches import (KernelCost, count_launch,
                                          counted_kernel)

NAME = "decode_attention"
NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 80, 96, 112, 128)
MAX_GROUP = 8
# the split plan: enough (request, KV head, split) blocks to fill the
# H100's 132 SMs four deep, each split at least SPLIT_MIN_ROWS rows, in
# multiples of SPLIT_QUANTUM
SPLIT_TARGET_BLOCKS = 4 * 132
SPLIT_MIN_ROWS = 256
SPLIT_QUANTUM = 64


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel splits each row's sequence: ``n_split`` splits of
    ``rows_per_split`` rows (the last one shorter), and the f32 scratch
    ``[B, K, n_split, G, hd + 2]`` of their ``(acc[hd], m, l)``."""
    n_split: int
    rows_per_split: int
    scratch_shape: Tuple[int, int, int, int, int]


@functools.cache
def split_plan(B: int, S: int, K: int, G: int, hd: int) -> SplitPlan:
    """The split of an ``S``-row cache, from the shapes alone (the lengths
    stay on the device): enough splits that ``B*K*n_split`` blocks fill the
    card, none shorter than ``SPLIT_MIN_ROWS`` unless ``S`` is; cached,
    being a pure function of the shapes."""
    if min(B, S, K, G, hd) < 1:
        raise ValueError(f"no split plan for B={B} S={S} K={K} G={G} "
                         f"hd={hd}")
    want = -(-SPLIT_TARGET_BLOCKS // (B * K))
    n = max(1, min(want, S // SPLIT_MIN_ROWS))
    rows = -(-S // n)
    rows = -(-rows // SPLIT_QUANTUM) * SPLIT_QUANTUM
    n = -(-S // rows)
    return SplitPlan(n, rows, (B, K, n, G, hd + 2))


def gqa_decode_attention_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor, *,
                               block_s: int = 256) -> torch.Tensor:
    """The plain version: the reference kernel's formula, tile for tile —
    K/V zero-padded to ``Sp``, an f32 online softmax over ``Sp/bs`` tiles
    and no tile skipped (counterpart of ``_decode_kernel``)."""
    acc, _, l = _online_state(q, k, v, lengths, block_s, quirk=True)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def _online_state(q, k, v, lengths, block_s: int, quirk: bool):
    """The plain versions' f32 online softmax over ``bs``-row tiles of
    the zero-padded cache: ``(acc [B,K,G,hd], m [B,K,G], l [B,K,G])``,
    unnormalised. With ``quirk`` a length-0 row weighs every padded slot
    1 (the TPU kernel's); without, it has no live row (``l = 0``)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    bs = min(block_s, S)
    pad = (-S) % bs
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, K, G, hd).float()
    lens = lengths.long()
    dev = q.device
    m = torch.full((B, K, G), NEG_INF, device=dev)
    l = torch.zeros((B, K, G), device=dev)
    acc = torch.zeros((B, K, G, hd), device=dev)
    for s0 in range(0, S + pad, bs):
        kc, vc = kf[:, s0:s0 + bs], vf[:, s0:s0 + bs]
        s = torch.einsum("bkgh,bskh->bkgs", qg, kc) * hd ** -0.5
        ids = s0 + torch.arange(bs, device=dev)
        valid = (ids[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if not quirk:
            p = torch.where(valid, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgs,bskh->bkgh", p, vc)
        m = m_new
    return acc, m, l


def decode_partials_torch(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor, *,
                          block_s: int = 256) -> torch.Tensor:
    """The partials entry's plain version: the whole plain version's
    online softmax, unnormalised, each row's and head's ``(acc, m, l)``
    over its first ``min(lengths, S)`` rows, ``[B, H, hd + 2]`` float32;
    ``acc = 0``, ``m = -inf``, ``l = 0`` for a length-0 row. One piece's
    partials combine to :func:`gqa_decode_attention_torch`'s bits."""
    B, H, hd = q.shape
    acc, m, l = _online_state(q, k, v, lengths, block_s, quirk=False)
    m = torch.where(l > 0, m, float("-inf"))
    return torch.cat([acc.reshape(B, H, hd), m.reshape(B, H, 1),
                      l.reshape(B, H, 1)], -1)


def _live_rows(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """Rows each request reads: its length capped at S, or all S rows for
    a length-0 row (the TPU kernel's quirk)."""
    lens = lengths.long().clamp(max=S)
    return torch.where(lens <= 0, torch.full_like(lens, S), lens)


def split_partial_torch(qg: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        empty: bool = False) -> torch.Tensor:
    """One split of one request: ``qg [K, G, hd]`` f32 against its rows
    ``kc/vc [n, K, hd]`` f32 -> the unnormalised ``(acc[hd], m, l)`` of
    each head, ``[K, G, hd + 2]``. ``empty`` weighs every row 1 (``m =
    0``), the contiguous kernel's length-0 quirk."""
    K, G, hd = qg.shape
    if empty:
        m = torch.zeros((K, G))
        p = torch.ones((K, G, kc.shape[0]))
    else:
        sc = torch.einsum("kgh,nkh->kgn", qg, kc) * hd ** -0.5
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
    return torch.cat([torch.einsum("kgn,nkh->kgh", p, vc), m[..., None],
                      p.sum(-1)[..., None]], -1)


def merge_live_splits_torch(part: torch.Tensor,
                            live: torch.Tensor) -> torch.Tensor:
    """The merge kernels' formula over the splits ``live [B, n]`` marks:
    ``sum_s acc_s e^{m_s - M} / max(sum_s l_s e^{m_s - M}, 1e-30)`` with
    ``M = max_s m_s``, 0 where a row has none. Splits not marked are never
    read. ``part [B, K, n, G, hd + 2]`` -> ``[B, K, G, hd]`` f32."""
    hd = part.shape[-1] - 2
    live = live[:, None, :, None]                        # [B, 1, n, 1]
    acc = torch.where(live[..., None], part[..., :hd], 0.0)
    m = torch.where(live, part[..., hd], float("-inf"))
    l = torch.where(live, part[..., hd + 1], 0.0)
    wt = torch.where(live, torch.exp(m - m.amax(2, keepdim=True)), 0.0)
    return (acc * wt[..., None]).sum(2) / (l * wt).sum(2).clamp_min(
        1e-30)[..., None]


def split_partials_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         plan: SplitPlan) -> torch.Tensor:
    """What the split kernel writes, split by split: for each (request,
    KV head, split, head) the unnormalised ``acc`` over the split's rows
    and its ``m`` and ``l``, as ``[..., hd + 2]`` f32. A length-0 row's
    splits weigh every row 1 (``m = 0``, ``l`` = rows, ``acc`` = the sum
    of V). A split wholly past a row's length is not written: NaN here."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    n_tok = _live_rows(lengths, S)
    empty = lengths.long() <= 0
    qg = q.reshape(B, K, G, hd).float()
    part = torch.full(plan.scratch_shape, float("nan"))
    for b in range(B):
        for s in range(plan.n_split):
            r0 = s * plan.rows_per_split
            r1 = min(r0 + plan.rows_per_split, int(n_tok[b]))
            if r0 < r1:
                part[b, :, s] = split_partial_torch(
                    qg[b], k[b, r0:r1].float(), v[b, r0:r1].float(),
                    bool(empty[b]))
    return part


def merge_partials_torch(part: torch.Tensor, lengths: torch.Tensor, S: int,
                         Sp: int, plan: SplitPlan) -> torch.Tensor:
    """The merge kernel's formula over the live splits of each row
    (:func:`merge_live_splits_torch`), and ``sum_s acc_s / Sp`` for a
    length-0 row. Splits past a row's length are never read. Returns
    ``[B, H, hd]`` f32."""
    B, K, n, G, hd2 = part.shape
    hd = hd2 - 2
    live = (torch.arange(n)[None, :] * plan.rows_per_split
            < _live_rows(lengths, S)[:, None])
    out = merge_live_splits_torch(part, live)
    acc = torch.where(live[:, None, :, None, None], part[..., :hd], 0.0)
    empty = (lengths.long() <= 0)[:, None, None, None]
    out = torch.where(empty, acc.sum(2) / Sp, out)
    return out.reshape(B, K * G, hd)


@functools.cache
def _entry(symbol: str = NAME):
    lib = _build.library(NAME)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_args(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,H,hd] and k/v [B,S,K,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    _, S, K, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or H % K or S < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not match")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] for B={B}, got "
                         f"{tuple(lengths.shape)}")
    if hd not in KERNEL_HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"unsupported head shape: G={H // K}, hd={hd} "
                         f"(need G <= {MAX_GROUP}, hd in {KERNEL_HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes must be one of float32/bfloat16 and equal, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("all inputs must be on one CUDA device")
    if not (q.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q and lengths must be contiguous")
    # the kernel copies 16-byte pieces of each [hd] row
    isz = k.element_size()
    if k.stride(3) != 1 or v.stride() != k.stride() \
            or any(s * isz % 16 for s in k.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"k and v need equal strides, a contiguous head "
                         f"dim and 16-byte aligned rows; got strides "
                         f"{k.stride()} and {v.stride()}")


def decode_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, *, block_s: int = 256) -> KernelCost:
    """One launch at these shapes, lengths unread: the padded cache's
    ``B * S`` K/V rows read once, ``4 H hd`` FLOPs a row; q, the output
    and the lengths once; the split scratch."""
    B, H, hd = q.shape
    _, S, K, _ = k.shape
    scratch = 0
    if B and S:
        n = 1
        for d in split_plan(B, S, K, H // K, hd).scratch_shape:
            n *= d
        scratch = 4 * n
    return KernelCost(
        flops=4.0 * B * S * H * hd,
        bytes=float(2 * B * S * K * hd * k.element_size()
                    + 2 * q.numel() * q.element_size()
                    + 4 * lengths.numel()),
        scratch=float(scratch))


@counted_kernel("decode_attention", decode_cost)
def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         block_s: int = 256) -> torch.Tensor:
    """Contiguous-cache decode attention: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, an output with no work
    for meta tensors."""
    if block_s < 1:
        raise ValueError(f"block_s must be >= 1, got {block_s}")
    if q.device.type == "cpu":
        return gqa_decode_attention_torch(q, k, v, lengths, block_s=block_s)
    out = torch.empty_like(q)
    S = k.shape[1] if k.dim() == 4 else 1
    bs = min(block_s, S)
    if _launch(NAME, q, k, v, lengths, out, -(-S // bs) * bs):
        count_launch(gqa_decode_attention)
    return out


def _launch(symbol: str, q, k, v, lengths, out, Sp: int) -> bool:
    """Launch the split kernel and the merge of ``symbol`` (the output or
    the partials into ``out``) on a CUDA tensor; False where there is no
    work (a meta tensor, an empty batch)."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k, v, lengths)
    B, H, hd = q.shape
    _, S, K, _ = k.shape
    if B == 0 or q.device.type == "meta":
        return False
    plan = split_plan(B, S, K, H // K, hd)
    part = torch.empty(plan.scratch_shape, dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry(symbol)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            lengths.data_ptr(), out.data_ptr(),
                            part.data_ptr(), B, S, K, H // K, hd,
                            *k.stride()[:3], Sp, plan.n_split,
                            plan.rows_per_split, _DTYPES[q.dtype],
                            torch.cuda.current_stream().cuda_stream)
    _build.check(NAME, rc)
    return True


def partials_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> KernelCost:
    """:func:`decode_cost` with the float32 partials ``[B, H, hd + 2]``
    written in place of the output."""
    c = decode_cost(q, k, v, lengths)
    B, H, hd = q.shape
    return dataclasses.replace(
        c, bytes=c.bytes - q.numel() * q.element_size()
        + 4 * B * H * (hd + 2))


@counted_kernel("decode_partials", partials_cost)
def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """The partials entry: each row's and head's unnormalised ``(acc, m,
    l)`` over its first ``lengths`` rows, ``[B, H, hd + 2]`` float32, an
    empty piece for a length-0 row (the split kernel and a merge that does
    not normalise, for CUDA tensors; the plain version for CPU
    tensors)."""
    if q.device.type == "cpu":
        return decode_partials_torch(q, k, v, lengths)
    B, H, hd = q.shape
    out = torch.empty((B, H, hd + 2), dtype=torch.float32, device=q.device)
    S = k.shape[1] if k.dim() == 4 else 1
    if _launch("decode_partials", q, k, v, lengths, out, S):
        count_launch(decode_partials)
    return out


# kernel launches since the last reset (counted only where the kernel runs;
# one a call, the split kernel and its merge together)
gqa_decode_attention.launches = 0
decode_partials.launches = 0
