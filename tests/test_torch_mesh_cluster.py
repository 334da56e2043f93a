"""A cluster of tensor-parallel replicas: ``ReplicatedCluster.sliced``
over a ``(2, 2)`` mesh of CPU devices, two replicas of a ``1 x 2``
model mesh each, against the reference's ``ReplicatedCluster.sliced``
over a ``(2, 2)`` mesh of host devices, on the same weights (the
reference's init carried across as numpy) and the same requests.

The reference runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_replication.py`` runs its sliced meshes). The port's
cluster runs in a process of its own
(``repro_torch.distributed.run_child`` of
``tensor_parallel.cluster_rank``), which leads both replicas as their
rank 0 and starts their other ranks as processes of their own, so no
test process joins a process group. The refusals need no process."""
import functools
import json
import os
import subprocess
import sys
import time
import types

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.replication import (slice_devices,  # noqa: E402
                                          slice_mesh)
from repro_torch.launch import tensor_parallel as TP  # noqa: E402
from repro_torch.launch.mesh import (MULTI_CARD_ITEM, make_mesh,  # noqa: E402
                                     make_model_mesh)
from repro_torch.serving import (EngineConfig, ReplicatedCluster,  # noqa: E402
                                 SamplingParams, sharegpt_like)

ENGINE = dict(max_batch=4, block_size=8, kv_pool_tokens=1024,
              max_model_len=96, prefill_bucket=16)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
KILL = "replica=1,step=5"

# the reference's cluster: the same requests (``_requests``) through its
# ``ReplicatedCluster.sliced`` over a (2, 2) mesh of four host devices,
# stepped in sync mode
_REFERENCE = """
import json
import jax
from repro.compat import make_mesh
from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.serving import (EngineConfig, ReplicatedCluster, SamplingParams,
                           sharegpt_like)
assert len(jax.devices()) == 4
cfg = reduced(get_config("opt-1.3b"))
params = JM.init_params(cfg, jax.random.PRNGKey(3))
reqs = sharegpt_like(8, 512, seed=5, mean_in=14, mean_out=12, max_len=40,
                     sigma=0.5)
reqs = [type(r)(r.req_id, r.prompt, sampling=SamplingParams(
            **%(sampled)r, seed=100 + i, max_new_tokens=r.max_new_tokens)
            if i %% 2 else r.sampling) for i, r in enumerate(reqs)]
mesh = make_mesh((2, 2), ("data", "model"))
cluster = ReplicatedCluster.sliced(cfg, params, EngineConfig(**%(engine)r),
                                   mesh, 2, mode="sync")
assert [dict(rep.mesh.shape) for rep in cluster.replicas] == \
    [{"data": 1, "model": 2}] * 2
cluster.run(reqs)
print(json.dumps({"tokens": [list(map(int, r.output_tokens)) for r in reqs],
                  "finish": [r.finish_reason for r in reqs],
                  "routed": [[r.req_id for r in rep.requests]
                             for rep in cluster.replicas]}))
""" % dict(sampled=SAMPLED, engine=ENGINE)


def _requests():
    """8 ShareGPT-shaped requests at t=0; every other one sampled."""
    reqs = sharegpt_like(8, 512, seed=5, mean_in=14, mean_out=12,
                         max_len=40, sigma=0.5)
    return [type(r)(r.req_id, r.prompt, sampling=SamplingParams(
                **SAMPLED, seed=100 + i, max_new_tokens=r.max_new_tokens)
                if i % 2 else r.sampling) for i, r in enumerate(reqs)]


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    return reduced(get_config("opt-1.3b")), jp


@functools.lru_cache(maxsize=None)
def _reference():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _mesh():
    return make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)


# the port's runs: (engine settings, cluster_rank's keywords)
RUNS = {
    "sync": ({}, dict(mode="sync")),
    "kill": ({}, dict(mode="sync", faults=KILL)),
    "respawn": (dict(overlap=True), dict(mode="thread", faults=KILL,
                                         respawn=True)),
}


@functools.lru_cache(maxsize=None)
def _port(name):
    tcfg, jp = _weights()
    ekw, kw = RUNS[name]
    return D.run_child(TP.cluster_rank, tcfg, EngineConfig(**ENGINE, **ekw),
                       _mesh(), 2, _requests(), jp, record=True, **kw)


# -------------------------------------------------------------- tokens --
def test_sliced_cluster_gives_the_reference_clusters_tokens():
    """Two replicas of two ranks each: every request's tokens and finish
    reason, and the routing, equal the reference's sliced cluster's."""
    want, got = _reference(), _port("sync")
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    assert got["routed"] == want["routed"]
    assert got["healthy"] == [True, True] and got["redriven"] == 0


def test_each_replicas_ranks_run_in_lock_step():
    """Each replica's rank 1 (a process of its own, following its rank
    0) issued exactly its rank 0's collectives; the two replicas' groups
    are their own (each replica's record holds its own steps alone)."""
    got = _port("sync")
    per_body = 2 + 2 * _weights()[0].n_layers
    for idx, record in enumerate(got["records"]):
        followers = got["followers"][idx]
        assert list(followers) == [1]
        assert followers[1]["record"] == record
        assert len(record) > 0 and len(record) % per_body == 0
        eng = got["engines"][idx]
        # every body was a prefill or a decode step of this replica's
        assert len(record) // per_body == eng["prefills"] + \
            eng["decode_steps"]


# ---------------------------------------------------------------- faults --
def test_killed_replica_loses_no_request():
    """An injected kill of replica 1 (two ranks) at its step 5: its
    requests are redriven to replica 0 and every request still ends with
    the reference's tokens; the dead replica's follower went on following
    until the run stopped it."""
    want, got = _reference(), _port("kill")
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    assert got["lost"] == 0 and got["redriven"] > 0
    assert got["healthy"] == [True, False]
    assert got["replica_faults"] == [0, 1]
    assert got["followers"][1][1]["record"] == got["records"][1]


def test_respawned_replica_reuses_its_group():
    """Threaded and overlapped, replica 1 killed and respawned over its
    pool, graphs and groups: every request gets the reference's tokens,
    both replicas end healthy, and each follower issued its rank 0's
    collectives, the respawned engine's among them."""
    want, got = _reference(), _port("respawn")
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    assert got["lost"] == 0 and got["redriven"] > 0
    assert got["healthy"] == [True, True]
    assert got["replica_faults"] == [0, 1]
    assert len(got["routed"][1]) > 0
    for idx in (0, 1):
        assert got["followers"][idx][1]["record"] == got["records"][idx]


# ------------------------------------------------------ slices, refusals --
def test_slices_are_model_meshes():
    """An ``(R, M)`` mesh splits into R ``(1, M)`` meshes, and a list of
    devices into slices a cluster runs as ``1 x n/R`` model meshes."""
    subs = slice_mesh(_mesh(), 2)
    assert [dict(s.shape) for s in subs] == [{"data": 1, "model": 2}] * 2
    for sub in subs:
        D.MeshGroup.check_mesh(sub)
    lists = slice_devices(["cpu"] * 4, 2)
    assert [dict(make_model_mesh(s).shape) for s in lists] == \
        [{"data": 1, "model": 2}] * 2


def test_data_slice_and_colocated_mesh_model_refused():
    """A slice with a data axis of 2 whose engine asks for what a data
    axis does not run (speculation) raises naming the data entry before
    any process starts (a slice with data > 1 runs:
    tests/test_torch_mesh_data.py); co-located replicas of a model over
    a mesh raise naming theirs."""
    tcfg, _ = _weights()
    with pytest.raises(NotImplementedError, match="left 1") as e:
        ReplicatedCluster.sliced(tcfg, None,
                                 EngineConfig(**ENGINE, speculate=True),
                                 _mesh(), 1)
    assert MULTI_CARD_ITEM in str(e.value)
    rank = types.SimpleNamespace(group=types.SimpleNamespace(size=2),
                                 device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="left 4") as e:
        ReplicatedCluster.colocated(rank, EngineConfig(**ENGINE), 2)
    assert MULTI_CARD_ITEM in str(e.value)
    assert "co-located" in str(e.value)


def test_a_rank_that_ends_early_is_seen():
    """A rank process that fails ends at once: ``exited`` names it (the
    cluster's step then raises instead of waiting on it in a
    collective), and ``collect`` raises with its traceback."""
    ranks = D.RankProcesses(TP.run_jobs, D.devices_mesh(1, "cpu"),
                            f"tcp://127.0.0.1:{D.free_port()}", (None,),
                            [0])
    try:
        for _ in range(600):
            if ranks.exited() is not None:
                break
            time.sleep(0.1)
        assert ranks.exited() == 0
        with pytest.raises(RuntimeError, match="NoneType"):
            ranks.collect(60.0)
    finally:
        ranks.stop()
