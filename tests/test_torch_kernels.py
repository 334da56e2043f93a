"""The port's attention kernels on the CPU: each CUDA kernel's plain
PyTorch version against the JAX Pallas kernel (interpret mode) and the
naive oracles of both packages, on the same numpy inputs. The CUDA
kernels themselves run only on the card (``chip_smoke.py``)."""
import itertools
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.paged_decode_attention import (  # noqa: E402
    paged_gqa_decode_attention as j_paged)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_MIN_ROWS, SPLIT_QUANTUM, SPLIT_TARGET_BLOCKS, SplitPlan,
    _check_args as decode_check_args, gqa_decode_attention,
    gqa_decode_attention_torch, merge_partials_torch, split_partials_torch,
    split_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL_HEAD_DIMS, _check_args as flash_check_args, flash_attention,
    flash_attention_torch, kernel_body)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    _check_args as paged_check_args, paged_gqa_decode_attention,
    paged_gqa_decode_attention_torch, paged_merge_partials_torch,
    paged_split_partials_torch, paged_split_plan)

# the reference's own tolerances (tests/test_paged_kernel.py)
TOL = {np.float32: 1e-4, "bfloat16": 3e-2}

PAGED_CASES = [
    # B, K, G, hd, BS, nb, NB, dtype  (tests/test_paged_kernel.py CASES,
    # plus the registry's G = 7 / hd = 80 and the engine's G = 1 shape)
    (3, 2, 4, 64, 16, 5, 32, np.float32),
    (2, 1, 8, 128, 32, 3, 16, np.float32),
    (4, 4, 1, 64, 16, 4, 24, "bfloat16"),
    (3, 2, 7, 80, 8, 4, 20, np.float32),
    (5, 4, 1, 64, 16, 6, 40, np.float32),
]


def _arrays(rng, dtype, *shapes):
    """numpy f32 draws, rounded to bfloat16 where asked, returned as
    (jax arrays, torch tensors) of the working dtype."""
    out_j, out_t = [], []
    for s in shapes:
        a = rng.normal(size=s).astype(np.float32)
        if dtype == "bfloat16":
            j = jnp.asarray(a, jnp.bfloat16)
            t = torch.from_numpy(a).to(torch.bfloat16)
        else:
            j, t = jnp.asarray(a), torch.from_numpy(a)
        out_j.append(j)
        out_t.append(t)
    return out_j, out_t


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=1e-2)


def _paged_inputs(B, K, G, hd, BS, nb, NB, dtype, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    (qj, kj, vj), (qt, kt, vt) = _arrays(rng, dtype, (B, K * G, hd),
                                         (NB, BS, K, hd), (NB, BS, K, hd))
    table = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    lengths = rng.integers(1, BS * nb + 1, B).astype(np.int32)
    lengths[0] = BS * nb                           # a full table
    for r in zero_rows:
        lengths[r] = 0
    return (qj, kj, vj), (qt, kt, vt), table, lengths


@pytest.mark.parametrize("B,K,G,hd,BS,nb,NB,dtype", PAGED_CASES)
def test_paged_plain_vs_pallas_and_oracles(B, K, G, hd, BS, nb, NB, dtype):
    (qj, kj, vj), (qt, kt, vt), table, lengths = _paged_inputs(
        B, K, G, hd, BS, nb, NB, dtype, seed=B * 100 + G)
    out = paged_gqa_decode_attention_torch(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lengths))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = j_paged(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                     interpret=True)
    _close(out, pallas, dtype)
    kc = kj[table].reshape(B, nb * BS, K, hd)
    vc = vj[table].reshape(B, nb * BS, K, hd)
    _close(out, jref.gqa_decode_attention_ref(qj, kc, vc,
                                              jnp.asarray(lengths)), dtype)
    tt = torch.from_numpy(table).long()
    oracle = tref.gqa_decode_attention_ref(
        qt, kt[tt].reshape(B, nb * BS, K, hd), vt[tt].reshape(B, nb * BS, K, hd),
        torch.from_numpy(lengths))
    _close(out, oracle.numpy(), dtype)


def test_paged_zero_length_rows_and_trash_entries():
    """Padding rows (length 0, a table of trash blocks) give exact zeros;
    table entries past a row's length may name any block."""
    (qj, kj, vj), (qt, kt, vt), table, lengths = _paged_inputs(
        4, 2, 2, 64, 8, 3, 16, np.float32, seed=8, zero_rows=(3,))
    table[3] = 15                                  # the trash block
    lengths[1] = 5                                 # entries 1..2 unused
    table[1, 1:] = 15
    out = paged_gqa_decode_attention_torch(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lengths))
    assert bool((out[3] == 0).all())
    assert bool(torch.isfinite(out).all())
    pallas = j_paged(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                     interpret=True)
    _close(out, pallas, np.float32)
    assert np.all(np.asarray(pallas)[3] == 0.0)


def test_paged_result_independent_of_block_placement():
    B, K, G, hd, BS, nb, NB = 2, 2, 2, 64, 16, 3, 16
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(B, K * G, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(B * nb, BS, K, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(B * nb, BS, K, hd)).astype(np.float32))
    lengths = torch.tensor([nb * BS, 20], dtype=torch.int32)
    outs = []
    for seed in (0, 1):
        perm = np.random.default_rng(seed).permutation(NB)[:B * nb]
        kp = torch.zeros(NB, BS, K, hd)
        vp = torch.zeros(NB, BS, K, hd)
        kp[perm] = kc
        vp[perm] = vc
        table = torch.from_numpy(perm.reshape(B, nb).astype(np.int32))
        outs.append(paged_gqa_decode_attention_torch(q, kp, vp, table,
                                                     lengths))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("B,nb,BS,K,G,hd", [
    (16, 64, 16, 32, 1, 64),   # the paged serve's shape: 2 splits of 512
    (1, 512, 16, 32, 1, 64),   # one long request
    (2, 256, 32, 2, 4, 128), (1, 4, 16, 2, 1, 64), (3, 5, 8, 2, 7, 80),
    (1, 100, 48, 1, 8, 96), (2, 128, 8, 1, 2, 64), (4, 33, 24, 8, 8, 80),
])
def test_paged_split_plan_covers_the_table_in_whole_blocks(B, nb, BS, K, G,
                                                           hd):
    """The paged plan is the contiguous kernel's over ``nb * BS`` rows,
    each split rounded up to whole blocks: its splits cover the table,
    none empty, and it depends on the shapes alone."""
    plan = paged_split_plan(B, nb, BS, K, G, hd)
    n, rows = plan.n_split, plan.rows_per_split
    base = split_plan(B, nb * BS, K, G, hd)
    assert plan.scratch_shape == (B, K, n, G, hd + 2)
    assert rows % BS == 0 and base.rows_per_split <= rows \
        < base.rows_per_split + BS
    assert (n - 1) * rows < nb * BS <= n * rows
    assert 1 <= n <= base.n_split
    assert plan == paged_split_plan(B, nb, BS, K, G, hd)


def test_paged_split_plan_at_the_serving_shape():
    plan = paged_split_plan(16, 64, 16, 32, 1, 64)
    assert (plan.n_split, plan.rows_per_split) == (2, 512)


@pytest.mark.parametrize("plan_of,shape", [
    (paged_split_plan, (16, 64, 16, 32, 1, 64)),
    (split_plan, (16, 704, 32, 1, 64)),
])
def test_split_plans_are_computed_once_a_shape(plan_of, shape):
    """A decode step calls each wrapper once a layer at one shape: the
    plan is cached, so the later calls compute nothing."""
    plan_of.cache_clear()
    first = plan_of(*shape)
    assert plan_of(*shape) is first
    info = plan_of.cache_info()
    assert (info.hits, info.misses) == (1, 1)


@pytest.mark.parametrize("zero", range(6))
def test_paged_split_plan_refuses_empty_shapes(zero):
    shape = [2, 4, 16, 2, 1, 64]
    shape[zero] = 0
    with pytest.raises(ValueError, match="paged split plan"):
        paged_split_plan(*shape)


def _split_and_merge(qt, kt, vt, table, lengths, plan):
    BS, nb = kt.shape[1], table.shape[1]
    part = paged_split_partials_torch(qt, kt, vt, table, lengths, plan)
    return part, paged_merge_partials_torch(part, lengths, nb, BS, plan)


def _forced_plan(B, nb, BS, K, G, hd, rows):
    n = -(-nb * BS // rows)
    return SplitPlan(n, rows, (B, K, n, G, hd + 2))


@pytest.mark.parametrize("B,K,G,hd,BS,nb,NB,dtype", PAGED_CASES)
@pytest.mark.parametrize("rows", ["plan", "one_block", "two_blocks"])
def test_paged_split_arithmetic_vs_plain_and_pallas(B, K, G, hd, BS, nb, NB,
                                                    dtype, rows):
    """The split kernel's partials, written split by split through the
    table, and the merge give the plain version's and the Pallas kernel's
    result; splits past a row's bound stay unwritten."""
    (qj, kj, vj), (qt, kt, vt), table, lengths = _paged_inputs(
        B, K, G, hd, BS, nb, NB, dtype, seed=B * 10 + G)
    plan = (paged_split_plan(B, nb, BS, K, G, hd) if rows == "plan" else
            _forced_plan(B, nb, BS, K, G, hd,
                         BS * (1 if rows == "one_block" else 2)))
    tbl, lens = torch.from_numpy(table), torch.from_numpy(lengths)
    part, out = _split_and_merge(qt, kt, vt, tbl, lens, plan)
    for b, n in enumerate(lengths):
        live = -(-int(n) // plan.rows_per_split)
        assert not bool(torch.isnan(part[b, :, :live]).any())
        assert bool(torch.isnan(part[b, :, live:]).all())
    _close(out, paged_gqa_decode_attention_torch(qt, kt, vt, tbl,
                                                 lens).float().numpy(), dtype)
    _close(out, j_paged(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                        interpret=True), dtype)


@pytest.mark.parametrize("which", ["zero", "one", "mid_block",
                                   "split_boundary", "full", "past"])
def test_paged_split_rows_at_the_edges(which):
    """Rows of length 0 (exact zeros, no live split), 1, ending mid-block,
    ending on a split boundary, filling the table and past it, over a
    table that the plan cuts into several splits; blocks at permuted ids,
    entries past each row's bound naming the trash block, or no block at
    all (the split arithmetic never reads them)."""
    B, K, G, hd, BS, nb = 2, 1, 2, 64, 8, 128
    plan = paged_split_plan(B, nb, BS, K, G, hd)
    rows = plan.rows_per_split
    assert plan.n_split == 4 and rows == 256
    length = {"zero": 0, "one": 1, "mid_block": rows + 3 * BS + 3,
              "split_boundary": 2 * rows, "full": nb * BS,
              "past": nb * BS + 9}[which]
    lengths = np.array([length, rows + 5], np.int32)
    NB = B * nb + 1                                # the last is the trash
    rng = np.random.default_rng(len(which))
    (qj, kj, vj), (qt, kt, vt) = _arrays(rng, np.float32, (B, K * G, hd),
                                         (NB, BS, K, hd), (NB, BS, K, hd))
    table = rng.permutation(NB - 1)[:B * nb].reshape(B, nb).astype(np.int32)
    poisoned = table.copy()
    for b, n in enumerate(lengths):
        used = min(-(-int(n) // BS), nb)
        table[b, used:] = NB - 1
        poisoned[b, used:] = NB + 1000             # out of the pool
    lens = torch.from_numpy(lengths)
    part, out = _split_and_merge(qt, kt, vt, torch.from_numpy(table), lens,
                                 plan)
    part_p, out_p = _split_and_merge(qt, kt, vt, torch.from_numpy(poisoned),
                                     lens, plan)
    assert torch.equal(out, out_p)
    assert torch.equal(part.isnan(), part_p.isnan())
    live = -(-min(length, nb * BS) // rows)
    assert bool(torch.isnan(part[0, :, live:]).all())
    assert not bool(torch.isnan(part[0, :, :live]).any())
    if which == "zero":
        assert live == 0 and bool((out[0] == 0).all())
    plain = paged_gqa_decode_attention_torch(qt, kt, vt,
                                             torch.from_numpy(table), lens)
    _close(out, plain.numpy(), np.float32)
    _close(out, j_paged(qj, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
                        interpret=True), np.float32)


@pytest.mark.parametrize("G,hd,what", [
    (16, 64, "G=16"), (2, 48, "hd=48"), (1, 32, "hd=32"), (4, 256, "hd=256"),
    (64, 32, "G=64")])
def test_paged_kernel_refuses_shapes_it_does_not_take(G, hd, what):
    """The wrapper's checks run before any build: head shapes the kernel
    has no body for raise ValueError naming the shape (the first port
    took any hd <= 128 and G <= 64)."""
    q = torch.zeros(1, 2 * G, hd)
    pool = torch.zeros(4, 16, 2, hd)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        paged_check_args(q, pool, pool, table, lengths)


def test_paged_kernel_refuses_an_empty_table():
    q = torch.zeros(1, 2, 64)
    pool = torch.zeros(4, 16, 2, 64)
    with pytest.raises(ValueError, match="nb >= 1"):
        paged_check_args(q, pool, pool, torch.zeros(1, 0, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32))


# tests/test_kernels.py DECODE_CASES: the same strided grid
DECODE_CASES = list(itertools.product(
    [1, 2, 5],            # batch
    [64, 100, 256],       # cache length
    [(1, 8), (2, 4), (4, 1), (8, 1)],   # (kv heads, group)
    [64, 128],            # head dim
    [32, 256],            # block_s
    [np.float32, "bfloat16"],
))[::7]


def _decode_inputs(B, S, K, G, hd, dtype, seed, lengths=None):
    rng = np.random.default_rng(seed)
    (qj, kj, vj), (qt, kt, vt) = _arrays(rng, dtype, (B, K * G, hd),
                                         (B, S, K, hd), (B, S, K, hd))
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    lengths = np.asarray(lengths, np.int32)
    return (qj, kj, vj), (qt, kt, vt), lengths


@pytest.mark.parametrize("B,S,kg,hd,bs,dtype", DECODE_CASES)
def test_decode_plain_vs_pallas_and_oracles(B, S, kg, hd, bs, dtype):
    K, G = kg
    (qj, kj, vj), (qt, kt, vt), lengths = _decode_inputs(
        B, S, K, G, hd, dtype, seed=B * 1000 + S + hd + bs)
    out = gqa_decode_attention_torch(qt, kt, vt, torch.from_numpy(lengths),
                                     block_s=bs)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_s=bs, interpret=True)
    _close(out, pallas, dtype)
    _close(out, jref.gqa_decode_attention_ref(qj, kj, vj,
                                              jnp.asarray(lengths)), dtype)
    _close(out, tref.gqa_decode_attention_ref(
        qt, kt, vt, torch.from_numpy(lengths)).numpy(), dtype)


@pytest.mark.parametrize("S,bs", [(100, 32), (64, 256), (100, 256)])
def test_decode_zero_length_rows_match_the_tpu_kernel(S, bs):
    """A length-0 row is the TPU kernel's ``sum_{j<S} V[j] / Sp`` (it
    never skips a tile), not zeros; both versions pin that quirk."""
    K, G, hd = 2, 4, 64
    (qj, kj, vj), (qt, kt, vt), lengths = _decode_inputs(
        3, S, K, G, hd, np.float32, seed=S + bs, lengths=[S, 0, 7])
    out = gqa_decode_attention_torch(qt, kt, vt, torch.from_numpy(lengths),
                                     block_s=bs)
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_s=bs, interpret=True)
    _close(out, pallas, np.float32)
    Sp = -(-S // min(bs, S)) * min(bs, S)
    quirk = vt[1].sum(0).repeat_interleave(G, dim=0) / Sp
    _close(out[1], quirk.numpy(), np.float32)


def test_decode_group_7_head_dim_80():
    """The registry's G = 7 (56 heads over 8) and hd = 80 shapes."""
    B, S, K, G, hd = 2, 100, 2, 7, 80
    (qj, kj, vj), (qt, kt, vt), lengths = _decode_inputs(
        B, S, K, G, hd, np.float32, seed=80, lengths=[100, 33])
    out = gqa_decode_attention_torch(qt, kt, vt, torch.from_numpy(lengths),
                                     block_s=32)
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_s=32, interpret=True)
    _close(out, pallas, np.float32)
    _close(out, jref.gqa_decode_attention_ref(qj, kj, vj,
                                              jnp.asarray(lengths)),
           np.float32)


def test_decode_reads_a_strided_cache_layer():
    """One layer of an ``[L, B, S, K, hd]`` cache, and a view with a
    batch stride of its own, give what a contiguous copy gives."""
    rng = np.random.default_rng(5)
    cache = torch.from_numpy(rng.normal(size=(2, 3, 40, 2, 64))
                             .astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(2, 4, 64)).astype(np.float32))
    lengths = torch.tensor([40, 9], dtype=torch.int32)
    layer = cache[1, ::2]                   # batch stride 2 * S * K * hd
    out = gqa_decode_attention(q, layer, layer, lengths)
    assert torch.equal(out, gqa_decode_attention_torch(
        q, layer.contiguous(), layer.contiguous(), lengths))


FLASH_CASES = [   # tests/test_kernels.py FLASH_CASES
    (2, 64, 64, 2, 2, 64, True, None, np.float32),
    (1, 96, 96, 1, 4, 32, True, 40, np.float32),
    (2, 64, 64, 4, 1, 64, False, None, "bfloat16"),
    (1, 128, 128, 2, 4, 128, True, None, "bfloat16"),
    (3, 32, 96, 1, 2, 64, True, None, np.float32),   # Sq != Skv
    (1, 100, 100, 2, 1, 64, True, None, np.float32),  # non-multiple sizes
]


@pytest.mark.parametrize("B,Sq,Skv,K,G,hd,causal,window,dtype", FLASH_CASES)
@pytest.mark.parametrize("blocks", [(32, 32), (128, 128)])
def test_flash_plain_vs_pallas_and_oracles(B, Sq, Skv, K, G, hd, causal,
                                           window, dtype, blocks):
    rng = np.random.default_rng(Sq + Skv + G)
    (qj, kj, vj), (qt, kt, vt) = _arrays(rng, dtype, (B, Sq, K * G, hd),
                                         (B, Skv, K, hd), (B, Skv, K, hd))
    bq, bs = blocks
    out = flash_attention_torch(qt, kt, vt, causal=causal, window=window,
                                block_q=bq, block_s=bs)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = j_flash(qj, kj, vj, causal=causal, window=window, block_q=bq,
                     block_s=bs, interpret=True)
    _close(out, pallas, dtype)
    _close(out, jref.flash_attention_ref(qj, kj, vj, causal=causal,
                                         window=window), dtype)
    _close(out, tref.flash_attention_ref(qt, kt, vt, causal=causal,
                                         window=window).numpy(), dtype)


def test_wrappers_take_the_plain_version_on_cpu():
    """A CPU tensor runs the plain version and counts no launch."""
    (_, _, _), (qt, kt, vt), table, lengths = _paged_inputs(
        2, 2, 2, 64, 8, 2, 8, np.float32, seed=4)
    p0, f0 = paged_gqa_decode_attention.launches, flash_attention.launches
    d0 = gqa_decode_attention.launches
    _, (dq, dk, dv), dl = _decode_inputs(2, 40, 2, 2, 64, np.float32, seed=4)
    assert torch.equal(
        ops.decode_attention(dq, dk, dv, torch.from_numpy(dl), block_s=16),
        gqa_decode_attention_torch(dq, dk, dv, torch.from_numpy(dl),
                                   block_s=16))
    assert gqa_decode_attention.launches == d0
    a = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(table),
                                   torch.from_numpy(lengths))
    b = paged_gqa_decode_attention_torch(qt, kt, vt, torch.from_numpy(table),
                                         torch.from_numpy(lengths))
    assert torch.equal(a, b)
    q = torch.randn(1, 40, 4, 64)
    k = torch.randn(1, 40, 2, 64)
    assert torch.equal(ops.prefill_attention(q, k, k),
                       flash_attention_torch(q, k, k))
    assert (paged_gqa_decode_attention.launches, flash_attention.launches) \
        == (p0, f0)


@pytest.mark.parametrize("G,hd,what", [(16, 64, "G=16"), (2, 48, "hd=48")])
def test_decode_kernel_refuses_shapes_it_does_not_take(G, hd, what):
    """The wrapper's checks run before any build: unsupported head shapes
    raise ValueError naming the shape."""
    q = torch.zeros(1, 2 * G, hd)
    k = torch.zeros(1, 8, 2, hd)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        decode_check_args(q, k, k, lengths)


def test_flash_rejects_empty_window():
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)


def test_build_paths_need_no_compiler_to_compute(tmp_path):
    """Library names hash the source, the shared headers and the flags;
    nothing is built here. An edited header gives every source a new
    path, so no stale library is loaded."""
    for name in _build.SOURCES:
        p = _build.library_path(name)
        assert (_build.CSRC / f"{name}.cu").exists()
        assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
        assert name in p.name
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["common.cuh"]
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    before = {n: _build.library_path(n, copy) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}
    with open(copy / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n, copy) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)


@pytest.mark.parametrize("B,S,K,G,hd", [
    (16, 704, 32, 1, 64),      # the gather serve's shape
    (1, 8192, 32, 1, 64),      # one long request
    (32, 192, 32, 1, 64),      # the static batch
    (1, 300, 1, 4, 64), (2, 4096, 2, 7, 80), (5, 1, 8, 1, 128),
    (1, 64, 1, 8, 96), (3, 100, 4, 2, 64),
])
def test_decode_split_plan_covers_the_cache(B, S, K, G, hd):
    """The split plan is a function of the shapes alone: its splits cover
    S with none empty, each a multiple of the quantum, none shorter than
    the minimum unless S is, and no more of them than the card needs."""
    plan = split_plan(B, S, K, G, hd)
    n, rows = plan.n_split, plan.rows_per_split
    assert plan.scratch_shape == (B, K, n, G, hd + 2)
    assert n >= 1 and rows % SPLIT_QUANTUM == 0
    assert (n - 1) * rows < S <= n * rows
    assert rows >= min(SPLIT_MIN_ROWS, S)
    assert n == 1 or B * K * (n - 1) < SPLIT_TARGET_BLOCKS
    assert plan == split_plan(B, S, K, G, hd)


def test_decode_split_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="split plan"):
        split_plan(1, 0, 1, 1, 64)


def _lengths_case(S, rows, which):
    return {"zero": 0, "one": 1, "mid_split": rows + rows // 2 + 1,
            "full": S, "past": S + 9}[which]


@pytest.mark.parametrize("S", [600, 1000, 2048])
@pytest.mark.parametrize("which", ["zero", "one", "mid_split", "full",
                                   "past"])
@pytest.mark.parametrize("bs", [32, 256])
def test_decode_merge_of_split_partials_equals_the_plain_version(S, which,
                                                                 bs):
    """The split kernel's partials, computed split by split on the CPU,
    and the merge kernel's formula give the plain version's result: the
    empty splits and the length-0 row's sum(V)/Sp included."""
    B, K, G, hd = 2, 1, 4, 64
    plan = split_plan(B, S, K, G, hd)
    assert plan.n_split > 1
    length = min(_lengths_case(S, plan.rows_per_split, which), S + 9)
    _, (qt, kt, vt), _ = _decode_inputs(B, S, K, G, hd, np.float32,
                                        seed=S + bs)
    lengths = torch.tensor([length, S], dtype=torch.int32)
    part = split_partials_torch(qt, kt, vt, lengths, plan)
    live = -(-min(max(length, 0) or S, S) // plan.rows_per_split)
    assert bool(torch.isnan(part[0, :, live:]).all())   # never written
    Sp = -(-S // min(bs, S)) * min(bs, S)
    out = merge_partials_torch(part, lengths, S, Sp, plan)
    if length <= S:
        ref = gqa_decode_attention_torch(qt, kt, vt, lengths, block_s=bs)
    else:   # lengths past S are taken as S
        ref = gqa_decode_attention_torch(
            qt, kt, vt, lengths.clamp(max=S), block_s=bs)
    _close(out, ref.numpy(), np.float32)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("hd", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dispatch_takes_every_shape_it_took_before(hd, dtype):
    """Every head dim and dtype the kernel took before still has a body:
    bf16 the tensor-core one, f32 the CUDA-core one, and the argument
    checks pass."""
    assert kernel_body(dtype, hd) == ("wgmma_bf16" if dtype == torch.bfloat16
                                      else "cuda_core_f32")
    q = torch.zeros(2, 70, 8, hd, dtype=dtype)
    k = torch.zeros(2, 90, 2, hd, dtype=dtype)
    flash_check_args(q, k, k)


@pytest.mark.parametrize("dtype,hd,error", [
    (torch.float16, 64, TypeError), (torch.bfloat16, 48, ValueError),
    (torch.float32, 256, ValueError)])
def test_flash_dispatch_refuses_what_no_body_takes(dtype, hd, error):
    with pytest.raises(error):
        kernel_body(dtype, hd)
