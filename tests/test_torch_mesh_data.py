"""Data parallelism inside one engine: the port's engine over ``2 x 1``
and ``2 x 2`` gloo meshes (each request's rows on one data rank, each
data rank over its own model axis), FSDP's weight blocks and logits, the
pool partitioned by data rank, and ``ReplicatedCluster.sliced`` of a
``(4, 1)`` mesh into two ``(2, 1)`` replicas, against the JAX reference
on the same weights (the reference's init carried across as numpy) and
the same requests.

The reference's serves run in one subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_replication.py`` runs its sliced meshes): its engine on one
device, its own engine over a ``(2, 1)`` mesh, and its sliced cluster.
It starts before the port's ranks are spawned and runs beside them. Each
port mesh is one spawn a module (``repro_torch.distributed.spawn`` of
``tensor_parallel.run_jobs``), every check's rank side in turn; the
cluster runs in a process of its own (``distributed.run_child``). The
pool, the placement and the shards need no process."""
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import rules_for as j_rules_for  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.census import mesh_collectives  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
from repro_torch.kvcache.view import step_fields, step_size  # noqa: E402
from repro_torch.launch import tensor_parallel as TP  # noqa: E402
from repro_torch.launch.mesh import (MULTI_CARD_ITEM, MULTI_CARD_LEFT,  # noqa: E402
                                     make_data_mesh, make_mesh)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (param_specs,  # noqa: E402
                                       params_from_numpy, rank_layout,
                                       tree_leaves)
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, ReplicatedCluster,
                                 SamplingParams, sharegpt_like)
from repro_torch.serving.engine import refuse_data  # noqa: E402
from repro_torch.serving.scheduler import place  # noqa: E402
from repro_torch.sharding import rules_for  # noqa: E402

ENGINE = dict(max_batch=4, block_size=8, kv_pool_tokens=1024,
              max_model_len=96, prefill_bucket=16)
# a pool whose data ranks' shares preempt (8 blocks of 8 a rank) under
# the long workload
PREEMPT = dict(ENGINE, kv_pool_tokens=128, max_model_len=64)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
# the reference's float32 kernel tolerance, of the largest logit
TOL = 1e-4
DECODE_STEPS = 4
MODES = {"sync": {}, "overlap": dict(overlap=True),
         "chunked": dict(prefill_chunk_tokens=16)}
# (data, model) of each spawned mesh
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
FSDP = {"act_replicated": True, "fsdp": True}
# the serves a mesh runs: (mode, rules); the overlapped one under FSDP
SERVES = (("sync", None), ("overlap", FSDP), ("chunked", None))

# the reference's serves of ``_requests``: its engine on one device and
# over a (2, 1) mesh, the one-device ``prefill`` and paged
# ``decode_step`` logits of ``_inputs``, and its sliced cluster of a
# (4, 1) mesh into two (2, 1) replicas
_REFERENCE = """
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.compat import make_mesh
from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.serving import (ContinuousBatchingEngine, EngineConfig,
                           ReplicatedCluster, SamplingParams, sharegpt_like)
from repro.sharding import rules_for
assert len(jax.devices()) == 4
cfg = reduced(get_config("opt-1.3b"))
params = JM.init_params(cfg, jax.random.PRNGKey(3))


def requests(mean_in, mean_out, max_len):
    reqs = sharegpt_like(8, 512, seed=5, mean_in=mean_in, mean_out=mean_out,
                         max_len=max_len, sigma=0.5)
    return [type(r)(r.req_id, r.prompt, sampling=SamplingParams(
                **%(sampled)r, seed=100 + i, max_new_tokens=r.max_new_tokens)
                if i %% 2 else r.sampling) for i, r in enumerate(reqs)]


def serve(mesh, ecfg, workload):
    reqs = requests(*workload)
    p = jax.device_put(params, NamedSharding(mesh, PartitionSpec()))
    ContinuousBatchingEngine(JM.Model(cfg, rules_for(mesh)), p,
                             EngineConfig(**ecfg)).run(reqs)
    return [list(map(int, r.output_tokens)) for r in reqs]


def logits(toks, lengths, feed):
    # prefill, then a paged decode_step a row of feed (blocks of 8,
    # tables 4 wide), on one device
    import jax.numpy as jnp
    from repro.kvcache.paged import PagedKVCache
    rules = rules_for(one)
    lp, cache, _ = JM.prefill(params, cfg, rules, {
        "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)},
        cache_len=len(toks[0]))
    pool = PagedKVCache(cfg, num_blocks=16, block_size=8, max_batch=2)
    for b, n in enumerate(lengths):
        pool.manager.allocate(b, n + 1)
        pool.write_prefill(b, jax.tree.map(lambda a: a[:, b:b + 1], cache))
    positions = list(lengths)
    decode = []
    for row in feed:
        for b in range(2):
            pool.manager.append_token(b, positions[b] + 1)
        view = pool.view([0, 1], positions, nb_pad=4, batch_pad=2)
        ld, new = JM.decode_step(params, cfg, rules, view, jnp.asarray(row),
                                 None)
        pool.commit(new)
        decode.append(np.asarray(ld).tolist())
        positions = [p + 1 for p in positions]
    return np.asarray(lp).tolist(), decode


one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
two = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
out = {"one": serve(one, %(engine)r, %(plain)r),
       "mesh": serve(two, %(engine)r, %(plain)r),
       "logits": logits(*%(inputs)r)}
reqs = requests(*%(plain)r)
cluster = ReplicatedCluster.sliced(cfg, params, EngineConfig(**%(engine)r),
                                   make_mesh((4, 1), ("data", "model")), 2,
                                   mode="sync")
assert [dict(rep.mesh.shape) for rep in cluster.replicas] == \\
    [{"data": 2, "model": 1}] * 2
cluster.run(reqs)
out["cluster"] = [list(map(int, r.output_tokens)) for r in reqs]
out["routed"] = [[r.req_id for r in rep.requests] for rep in cluster.replicas]
print(json.dumps(out))
"""
# (mean_in, mean_out, max_len) of the plain and the preempting workloads
PLAIN = (14, 12, 40)
LONG = (20, 40, 62)


def _requests(workload=PLAIN):
    """8 ShareGPT-shaped requests at t=0; every other one sampled (its
    own seed)."""
    mean_in, mean_out, max_len = workload
    reqs = sharegpt_like(8, 512, seed=5, mean_in=mean_in, mean_out=mean_out,
                         max_len=max_len, sigma=0.5)
    return [type(r)(r.req_id, r.prompt, sampling=SamplingParams(
                **SAMPLED, seed=100 + i, max_new_tokens=r.max_new_tokens)
                if i % 2 else r.sampling) for i, r in enumerate(reqs)]


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    return jcfg, reduced(get_config("opt-1.3b")), jp


@functools.lru_cache(maxsize=None)
def _reference_process():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    toks, lengths, feed = _inputs(reduced(get_config("opt-1.3b")).vocab_size)
    script = _REFERENCE % dict(sampled=SAMPLED, engine=ENGINE, plain=PLAIN,
                               inputs=(toks.tolist(), lengths.tolist(),
                                       feed.tolist()))
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference subprocess's results, once every port run is done
    (they run beside it)."""
    proc = _reference_process()
    for grid in MESHES:
        _ranks(grid)
    _cluster()
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def _inputs(vocab):
    rng = np.random.default_rng(11)
    lengths = np.array([13, 21], np.int32)
    toks = np.zeros((2, 24), np.int32)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.integers(0, vocab, n)
    feed = rng.integers(0, vocab, (DECODE_STEPS, 2)).astype(np.int32)
    return toks, lengths, feed


@functools.lru_cache(maxsize=None)
def _ranks(mesh):
    """One spawn of the mesh's gloo ranks running every check's rank
    side: each of :data:`SERVES` (collectives recorded), the FSDP logits
    (recorded) and, over 2 x 1, the preempting serve."""
    _reference_process()            # the reference runs meanwhile
    _, tcfg, jp = _weights()
    jobs = [(TP.serve_rank, (tcfg, EngineConfig(**ENGINE, **MODES[mode]),
                             _requests(), jp),
             dict(record=True, rules=rules)) for mode, rules in SERVES]
    jobs.append((TP.logits_rank, (tcfg, jp, *_inputs(tcfg.vocab_size)),
                 dict(rules=FSDP, record=True)))
    if mesh == "2x1":
        jobs.append((TP.serve_rank, (tcfg, EngineConfig(**PREEMPT),
                                     _requests(LONG), jp), {}))
    data, m = MESHES[mesh]
    return D.spawn(TP.run_jobs, D.devices_mesh(data * m, "cpu", data=data),
                   jobs)


@functools.lru_cache(maxsize=None)
def _cluster():
    _reference_process()            # the reference runs meanwhile
    _, tcfg, jp = _weights()
    return D.run_child(TP.cluster_rank, tcfg, EngineConfig(**ENGINE),
                       make_mesh((4, 1), ("data", "model"), ["cpu"] * 4), 2,
                       _requests(), jp, mode="sync", record=True)


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


# ------------------------------------------------------------- engine --
@pytest.mark.parametrize("mode,flags", SERVES)
@pytest.mark.parametrize("grid", list(MESHES))
def test_engine_tokens_equal_the_reference_engine(grid, mode, flags):
    """8 requests (half sampled) served by one engine over the mesh, each
    row on one data rank: every request's greedy and sampled tokens equal
    the reference engine's on one device, in the sync, overlapped (under
    FSDP) and chunked modes; every rank launched the same kernels."""
    out = [r[SERVES.index((mode, flags))] for r in _ranks(grid)]
    assert out[0]["tokens"] == _reference()["one"]
    assert all(f == "length" for f in out[0]["finish"])
    for r in out[1:]:
        assert r["launches"] == out[0]["launches"]
    if mode == "chunked":
        assert out[0]["chunks"] > 0 and out[0]["prefills"] == 0
    else:
        assert out[0]["prefills"] == 8


def test_the_reference_engine_over_a_data_axis_gives_the_same_tokens():
    """The reference's own engine over a ``(2, 1)`` mesh of host devices
    gives its one-device tokens: the data axis does not change a
    request's tokens there either."""
    ref = _reference()
    assert ref["mesh"] == ref["one"]


@pytest.mark.parametrize("mode,flags", SERVES)
@pytest.mark.parametrize("grid", list(MESHES))
def test_every_rank_issues_the_same_collectives(grid, mode, flags):
    """The lock step over a data axis: every rank of the mesh recorded the
    same collectives (op, shape, dtype) in the same order through the
    serve, each step's outputs gathered over the data axis once (a
    decode step's tokens and finiteness, a prefill's logits; a serial
    prefill step carries up to one admission a data rank), and under
    FSDP each layer's weights gathered."""
    out = [r[SERVES.index((mode, flags))] for r in _ranks(grid)]
    rec = out[0]["record"]
    assert rec and all(r["record"] == rec for r in out[1:])
    c = out[0]
    assert [op for op, _, _ in rec].count("gather_rows") == \
        c["decode_steps"] + c["prefill_steps"]
    if mode != "chunked":
        # serial admissions prefill together, one a data rank a step
        assert c["prefill_steps"] < c["prefills"]
    assert ("gather_weight" in {op for op, _, _ in rec}) == \
        (flags is FSDP)


_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "gather_rows": "all-gather",
          "gather_weight": "all-gather"}


def _bytes(record, data, m):
    """The census's bytes of recorded collectives, by kind."""
    got = dict.fromkeys(("all-reduce", "all-gather", "reduce-scatter"), 0.0)
    for op, shape, dtype in record:
        n = np.prod(shape) * torch.empty((), dtype=getattr(
            torch, dtype.split(".")[-1])).element_size()
        got[_KINDS[op]] += {"all_reduce": 2 * n, "all_gather": m * n,
                            "reduce_scatter": n, "gather_rows": data * n,
                            "gather_weight": data * n}[op]
    return got


def _layout(grid, flags):
    data, m = MESHES[grid]
    _, tcfg, _ = _weights()
    rules = rules_for(make_mesh((data, m), ("data", "model")), **flags)
    return tcfg, rules, rank_layout(tcfg, rules, 0)


@pytest.mark.parametrize("grid", list(MESHES))
def test_census_counts_the_collectives_issued(grid):
    """``mesh_collectives`` prices what the ranks issued: under FSDP the
    logits' prefill (a data rank's row of 24) and 4 decode steps, the
    weights gathered a layer included, equal the recorded bytes kind by
    kind; and each step of the sync serve (cut at its gather of outputs)
    equals the census of its variant and rows with the outputs'
    gather."""
    data, m = MESHES[grid]
    out = _ranks(grid)[0][len(SERVES)]
    rec = [r for r in out["record"] if r[0] != "gather_rows"]
    tcfg, rules, lay = _layout(grid, FSDP)
    assert lay.w_in
    want = mesh_collectives(tcfg, lay, "prefill", 24, 1, rules)
    for kind, n in mesh_collectives(tcfg, lay, "decode", 1, 1,
                                    rules).items():
        want[kind] += DECODE_STEPS * n
    assert _bytes(rec, data, m) == want
    tcfg, rules, lay = _layout(grid, {"act_replicated": True})
    rec = _ranks(grid)[0][0]["record"]
    start = 0
    for i, (op, shape, dtype) in enumerate(rec):
        if op != "gather_rows":
            continue
        step = rec[start:i + 1]
        # the embedding's partial sums come first: [rows, S, d]
        b, s = step[0][1][:2]
        variant = "decode" if dtype == "torch.int32" else "prefill"
        assert _bytes(step, data, m) == mesh_collectives(
            tcfg, lay, variant, b * s, b, rules, outputs=True), (i, variant)
        start = i + 1
    assert start == len(rec)


# --------------------------------------------------------------- fsdp --
@pytest.mark.parametrize("grid", list(MESHES))
def test_fsdp_blocks_are_the_reference_specs_blocks(grid):
    """Under ``fsdp`` every leaf of each rank's shard is the numpy block
    the reference's spec gives that device of the ``(D, M)`` mesh (the
    ``W_IN`` dim over ``data``, the model dims over ``model``), and the
    plan gathers exactly the weights whose ``W_IN`` dim is sharded."""
    data, m = MESHES[grid]
    jcfg, tcfg, jp = _weights()
    jrules = j_rules_for(AbstractMesh((data, m), ("data", "model")),
                         fsdp=True, act_replicated=True)
    trules = rules_for(make_mesh((data, m), ("data", "model")), **FSDP)
    jspecs = dict(tree_leaves(JM.param_shardings(jcfg, jrules)))
    specs = dict(tree_leaves(param_specs(tcfg)))
    whole = dict(tree_leaves(jp))
    for rank in range(data * m):
        d, mr = divmod(rank, m)
        cut = dict(tree_leaves(params_from_numpy(tcfg, jp, rules=trules,
                                                 rank=rank)))
        on_data = set()
        for path, ps in specs.items():
            spec = tuple(jspecs[path].spec)
            spec += (None,) * (len(ps.shape) - len(spec))
            assert trules.spec(ps.logical, ps.shape) == spec, path
            index = []
            for dim, axis in zip(ps.shape, spec):
                if axis is None:
                    index.append(slice(None))
                    continue
                i, n = {"data": (d, data), "model": (mr, m)}[axis]
                index.append(slice(i * dim // n, (i + 1) * dim // n))
                if axis == "data":
                    on_data.add(path.split("/")[-1])
            np.testing.assert_array_equal(cut[path].numpy(),
                                          whole[path][tuple(index)], path)
        lay = rank_layout(tcfg, trules, rank)
        assert {name for name, _ in lay.w_in} == on_data == {
            "wq", "wk", "wv", "wo", "w1", "w2", "unemb"}
        assert (lay.data, lay.data_rank, lay.rank) == (data, d, mr)


@pytest.mark.parametrize("grid", list(MESHES))
def test_fsdp_logits_match_the_reference(grid):
    """Under ``fsdp`` over the mesh (each data rank prefilling and
    decoding its row, each layer gathering its weights), the ``prefill``
    and 4 paged ``decode_step`` logits, gathered over the data axis, come
    within the reference's float32 kernel tolerance (1e-4 of the largest)
    of the reference's on one device; every rank returns the same."""
    want_prefill, want_decode = (np.asarray(a, np.float32)
                                 for a in _reference()["logits"])
    outs = [r[len(SERVES)] for r in _ranks(grid)]
    for out in outs:
        np.testing.assert_array_equal(out["prefill"], outs[0]["prefill"])
        np.testing.assert_array_equal(out["decode"], outs[0]["decode"])
    _close(outs[0]["prefill"], want_prefill)
    _close(outs[0]["decode"], want_decode)


# --------------------------------------------------------------- pool --
def test_the_pool_is_partitioned_by_data_rank():
    """The departure from the reference's unsharded pool (ROADMAP.md
    queue 3): over 2 data ranks a request takes blocks only from its
    rank's half, keeps its rank through a preemption's release, and its
    tables are staged in its rank's ids; every rank's padding rows and
    padding prefill write to that rank's own trash block."""
    _, tcfg, _ = _weights()
    pool = PagedKVCache(tcfg, num_blocks=16, block_size=8,
                        device=torch.device("cpu"), data=2)
    mgr = pool.manager
    assert pool.pool["k"].shape[1] == 9 and pool.trash_block == 8
    assert pool.pool_bytes == pool.block_bytes * 8
    mgr.assign(7, 1)
    first = mgr.allocate(7, 20)
    assert all(8 <= b < 16 for b in first)
    mgr.release(7)                   # a preemption keeps the rank
    assert mgr.rank_of(7) == 1 and mgr.free_on(1) == 8
    again = mgr.allocate(7, 40)
    assert all(8 <= b < 16 for b in again)
    mgr.assign(3, 0)
    mgr.allocate(3, 9)
    f = step_fields(np.zeros(step_size(4, 8), np.int32), 4, 8)
    pool.fill_view(f, [7], [39])
    assert list(f["tables"][0, :5]) == [b - 8 for b in again]
    assert (f["tables"][1:] == pool.trash_block).all()
    assert (f["lengths"][1:] == 0).all()
    from repro_torch.kvcache.view import prefill_fields, prefill_size
    p = prefill_fields(np.zeros(prefill_size(16, 0), np.int32), 16, 0)
    pool.fill_padding(p)
    assert (p["blocks"] == pool.trash_block).all() and p["n"][0] == 1
    mgr.release(7)
    mgr.disown(7)
    with pytest.raises(KeyError):
        mgr.rank_of(7)


def test_admission_places_each_request_on_one_data_rank():
    """A new request takes a free seat on the rank with the most free
    blocks, ties to the lower rank; a re-admitted one waits for its own
    rank's seat even when another rank has seats and blocks free (the
    departure's visible effect)."""
    assert place([3, 5], [0, 0], 2) == 1
    assert place([5, 5], [0, 0], 2) == 0
    assert place([9, 1], [2, 0], 2) == 1
    assert place([9, 9], [2, 2], 2) is None
    assert place([0, 16], [2, 0], 2, bound=0) is None
    assert place([0, 16], [1, 0], 2, bound=0) == 0


def test_preempting_shares_give_the_one_device_tokens():
    """Over 2 x 1 with 8 blocks a rank, long outputs preempt requests on
    a full rank (re-admitted to the same rank, their blocks released and
    taken again in its range): every request's tokens equal the port's
    engine's on one device, on the whole pool (whose tokens equal the
    reference engine's: tests/test_torch_engine.py)."""
    out = _ranks("2x1")[0][len(SERVES) + 1]
    assert out["preemptions"] > 0
    _, tcfg, jp = _weights()
    reqs = _requests(LONG)
    model = Model(tcfg, params_from_numpy(tcfg, jp), device="cpu")
    ContinuousBatchingEngine(model, EngineConfig(**PREEMPT),
                             device="cpu").run(reqs)
    assert out["tokens"] == [list(r.state.output_tokens) for r in reqs]


# ------------------------------------------------------------ cluster --
def test_sliced_cluster_of_data_replicas_gives_the_reference_tokens():
    """``ReplicatedCluster.sliced`` splits a ``(4, 1)`` mesh into two
    ``(2, 1)`` replicas, each one engine over its slice's data axis led
    from the cluster's process, and serves the reference cluster's
    tokens and routing; each replica's follower issued its rank 0's
    collectives."""
    got, ref = _cluster(), _reference()
    assert got["tokens"] == ref["cluster"]
    assert got["routed"] == ref["routed"]
    assert got["lost"] == 0
    for idx in (0, 1):
        assert got["followers"][idx][1]["record"] == got["records"][idx]


# ----------------------------------------------------------- refusals --
def test_what_a_data_axis_still_refuses_names_its_roadmap_item():
    """The prefix cache, speculation, the gather mode and the non-dense
    families over a data axis raise before anything starts, naming the
    ROADMAP's first entry, which lists exactly them; so do a batch or a
    pool that does not split over the data ranks."""
    assert list(MULTI_CARD_LEFT)[0] == "data"
    for what in ("the prefix cache", "speculation", "the gather mode",
                 "the non-dense families"):
        assert what in MULTI_CARD_LEFT["data"]
    _, tcfg, _ = _weights()
    mesh = make_data_mesh(["cpu"] * 2, 2)
    for kw in (dict(prefix_cache=True), dict(speculate=True),
               dict(decode_mode="gather")):
        with pytest.raises(NotImplementedError, match="left 1") as e:
            ReplicatedCluster.sliced(tcfg, None, EngineConfig(**ENGINE, **kw),
                                     mesh, 1)
        assert MULTI_CARD_ITEM in str(e.value)
    with pytest.raises(ValueError, match="max_batch"):
        ReplicatedCluster.sliced(tcfg, None,
                                 EngineConfig(**dict(ENGINE, max_batch=3)),
                                 mesh, 1)
    with pytest.raises(NotImplementedError, match="left 1") as e:
        Model(reduced(get_config("mamba2-1.3b")), mesh=mesh)
    assert MULTI_CARD_ITEM in str(e.value)
    for kw in (dict(kv_pool_tokens=136), dict(kv_pool_tokens=128)):
        with pytest.raises(ValueError, match="does not split"):
            refuse_data(EngineConfig(**dict(ENGINE, **kw)), 2)
    refuse_data(EngineConfig(**PREEMPT), 2)
