"""The port's sharding rules against the JAX reference's, on the CPU: every
parameter leaf's logical axes for every config of the registry (with and
without ``attn_row_parallel``); specs and shard shapes of the
parameters, the optimizer state and the decode caches (bytes a device,
specs a kind: the port's cache is flat where the reference's is a
``stack``/``rem`` tree) on the 1 x 1, 16 x 16 and 2 x 16 x 16 meshes
under every combination of ``shard_kv_seq``, ``fsdp`` and
``act_replicated``, the reference's rules built on an ``AbstractMesh``
(no devices); the reference's own two sharding tests as cases; and the
port's meshes, ``slice_mesh`` and ``ReplicatedCluster.sliced`` over a
mesh."""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.registry import ALL as J_ALL  # noqa: E402
from repro.configs.registry import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import ParamSpec as JParamSpec  # noqa: E402
from repro.sharding import rules_for as j_rules_for  # noqa: E402
from repro.training.train import opt_state_sds as j_opt_state_sds  # noqa
from repro.training.train import (  # noqa: E402
    opt_state_shardings as j_opt_state_shardings)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import CROSS, SSM  # noqa: E402
from repro_torch.configs.registry import ALL  # noqa: E402
from repro_torch.core.replication import slice_mesh  # noqa: E402
from repro_torch.launch.dryrun import shard_bytes  # noqa: E402
from repro_torch.launch.mesh import (make_mesh,  # noqa: E402
                                     make_production_mesh, make_test_mesh,
                                     mesh_chips)
from repro_torch.models.params import (cache_sds,  # noqa: E402
                                       cache_shardings, param_sds,
                                       param_shardings, param_specs,
                                       plan_structure, tree_leaves)
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving.cluster import ReplicatedCluster  # noqa: E402
from repro_torch.sharding import rules_for, shard_shape  # noqa: E402
from repro_torch.training.train import (opt_state_sds,  # noqa: E402
                                        opt_state_shardings)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = list(itertools.product((False, True), repeat=3))
DECODE = (128, 32768)       # decode_32k's batch and cache slots


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), make_mesh(shape, axes)


def _rules(name, flags):
    kv, fsdp, act = flags
    jm, tm = _meshes(name)
    kw = dict(shard_kv_seq=kv, fsdp=fsdp, act_replicated=act)
    return j_rules_for(jm, **kw), rules_for(tm, **kw)


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _j_leaves(tree, is_leaf):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return sorted((_path(p), v) for p, v in flat)


def _is_jspec(x):
    return isinstance(x, JParamSpec)


def _is_sharding(x):
    return isinstance(x, NamedSharding)


@pytest.mark.parametrize("row_parallel", [False, True],
                         ids=["default", "attn_row_parallel"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_logical_axes_equal_reference(name, row_parallel):
    """Every parameter leaf's path, shape and logical axes equal the
    reference's ``abstract_params``."""
    jcfg = dataclasses.replace(j_get_config(name),
                               attn_row_parallel=row_parallel)
    tcfg = dataclasses.replace(get_config(name),
                               attn_row_parallel=row_parallel)
    want = [(p, s.shape, s.logical) for p, s in
            _j_leaves(JM.abstract_params(jcfg), _is_jspec)]
    got = sorted((p, s.shape, s.logical)
                 for p, s in tree_leaves(param_specs(tcfg)))
    assert got == want
    assert set(ALL) == set(J_ALL)


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _param_pairs(name, jr, tr):
    """The reference's shardings and shapes by path; the port's specs (a
    spec is a tuple, so they are looked up along the parameters' paths)
    and meta tensors."""
    jsh = _j_leaves(JM.param_shardings(j_get_config(name), jr),
                    _is_sharding)
    jsd = dict(_j_leaves(JM.param_sds(j_get_config(name)), None))
    specs = param_shardings(get_config(name), tr)
    tmeta = dict(tree_leaves(param_sds(get_config(name))))
    return jsh, jsd, {p: _at(specs, p) for p in tmeta}, tmeta


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "kv%d-fsdp%d-act%d"
                         % f)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_optimizer_specs_equal_reference(mesh_name, flags):
    """Each parameter's spec and shard shape, and the optimizer state's,
    equal the reference's ``rules.spec`` and ``shard_shape`` for every
    assigned config."""
    jr, tr = _rules(mesh_name, flags)
    for name in J_ASSIGNED:
        jsh, jsd, tsp, tmeta = _param_pairs(name, jr, tr)
        assert sorted(tsp) == [p for p, _ in jsh]
        for path, sh in jsh:
            shape = jsd[path].shape
            assert tuple(tsp[path]) == tuple(sh.spec), (name, path)
            assert tuple(tmeta[path].shape) == tuple(shape)
            assert shard_shape(tsp[path], shape, tr.mesh) == \
                tuple(sh.shard_shape(shape)), (name, path)
        jcfg, tcfg = j_get_config(name), get_config(name)
        jo, jo_sd = j_opt_state_shardings(jcfg, jr), j_opt_state_sds(jcfg)
        to, to_sd = opt_state_shardings(tcfg, tr), opt_state_sds(tcfg)
        for i in (0, 1):
            j_bytes = sum(np.prod(s.shard_shape(x.shape)) * 4 for (_, s), (
                _, x) in zip(_j_leaves(jo[i], _is_sharding),
                             _j_leaves(jo_sd[i], None)))
            assert shard_bytes(to_sd[i], to[i], tr.mesh) == j_bytes
            assert all(t.dtype == torch.float32 and t.is_meta
                       for _, t in tree_leaves(to_sd[i]))
        assert tuple(jo[2].spec) == to[2] == ()
        assert to_sd[2].dtype == torch.int32 and jo_sd[2].shape == ()


def _reference_cache_by_kind(cfg, jr, batch, kv_len):
    """The reference cache's leaves as ``(port name, spec with the layers
    dim, per-device bytes)``."""
    slots, n_rep, rem = plan_structure(get_config(cfg.name))
    plan = cfg.block_plan()
    kinds = list(slots) + list(plan[n_rep * len(slots):])
    sh = JM.cache_shardings(cfg, jr, batch, kv_len)
    sd = JM.cache_sds(cfg, batch, kv_len)
    out = []
    for where, n_entries in (("stack", len(slots)), ("rem", rem)):
        for i in range(n_entries):
            kind = kinds[i if where == "stack" else len(slots) + i]
            for leaf, s in sh[where][i].items():
                x = sd[where][i][leaf]
                spec = tuple(s.spec) + (None,) * (len(x.shape) - len(s.spec))
                if where == "rem":
                    spec = (None,) + spec
                name = {"k": "xk", "v": "xv"}[leaf] if kind == CROSS \
                    else leaf
                nbytes = np.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                out.append((name, spec, nbytes, kind))
    return out


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "kv%d-fsdp%d-act%d"
                         % f)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_and_bytes_equal_reference(mesh_name, flags):
    """The decode cache (decode_32k's batch and slots, and a batch of one
    over an 8192-slot ring) holds the reference's bytes a device, and each
    of its kinds (K/V, SSM state, image K/V) the reference's spec."""
    jr, tr = _rules(mesh_name, flags)
    for name, (batch, kv_len) in itertools.product(
            J_ASSIGNED, (DECODE, (1, 8192))):
        jcfg, tcfg = j_get_config(name), get_config(name)
        ref = _reference_cache_by_kind(jcfg, jr, batch, kv_len)
        tsp = cache_shardings(tcfg, tr, batch, kv_len)
        tsd = cache_sds(tcfg, batch, kv_len)
        assert shard_bytes(tsd, tsp, tr.mesh) == sum(b for *_, b, _ in ref)
        for leaf, spec, _, kind in ref:
            assert tsp[leaf] == spec, (name, leaf, kind)
        assert set(tsp) == {leaf for leaf, *_ in ref}
        n_ssm = sum(k == SSM for *_, k in ref) // 2
        assert ("h" in tsp) == bool(n_ssm)


@pytest.mark.parametrize("logical,shape", [
    (("batch", "kv_seq", "kv_heads", None), (8, 64, 2, 64)),
    (("d_model", "d_ff"), (64, 64)),
    (("batch", "seq", "vocab"), (3, 5, 7)),
    (("experts", "d_model", "d_ff"), (64, 2048, 1024)),
], ids=["divisibility-fallback", "no-duplicate-axes", "indivisible",
        "experts"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_spec_cases(mesh_name, logical, shape):
    """The reference's sharding tests (``tests/test_substrate.py``'s
    divisibility fallback and no duplicate axes) as cases: every spec
    equals the reference's, no mesh axis appears twice, and the shard
    shape is the reference's."""
    for flags in FLAGS:
        jr, tr = _rules(mesh_name, flags)
        want = jr.spec(logical, shape)
        got = tr.spec(logical, shape)
        assert got == tuple(want)
        flat = [a for s in got if s is not None
                for a in ((s,) if isinstance(s, str) else s)]
        assert len(flat) == len(set(flat))
        assert shard_shape(got, shape, tr.mesh) == \
            tuple(NamedSharding(jr.mesh, want).shard_shape(shape))


def test_shard_shape_refuses_an_indivisible_dim():
    mesh = make_production_mesh()
    assert shard_shape(("data", None), (32, 3), mesh) == (2, 3)
    with pytest.raises(ValueError, match="divide"):
        shard_shape(("data",), (24,), mesh)


def test_meshes():
    """The production meshes' shapes and names; the test mesh is 1 x 1
    over the device asked for."""
    m = make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16} and m.devices is None
    m2 = make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model")
    assert mesh_chips(m2) == 512 and mesh_chips(m) == 256
    t = make_test_mesh("cpu")
    assert t.axis_names == ("data", "model") and mesh_chips(t) == 1
    assert t.devices.shape == (1, 1) and t.devices[0, 0].type == "cpu"
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_slice_mesh_splits_the_leading_axis():
    """``slice_mesh`` splits the device array along the data axis in
    order, keeping the axis names (the reference's ``slice_mesh``), and
    refuses a count that does not divide it."""
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = make_mesh((4, 2), ("data", "model"), devs)
    parts = slice_mesh(mesh, 2)
    assert [dict(p.shape) for p in parts] == [{"data": 2, "model": 2}] * 2
    assert [list(p.devices.flat) for p in parts] == [devs[:4], devs[4:]]
    assert all(p.axis_names == ("data", "model") for p in parts)
    with pytest.raises(ValueError, match="not divisible"):
        slice_mesh(mesh, 3)
    with pytest.raises(ValueError):
        slice_mesh(make_production_mesh(), 2)


def test_sliced_cluster_takes_a_mesh():
    """``ReplicatedCluster.sliced`` takes a mesh, one replica a device
    slice; a slice of two devices along its data axis whose engine asks
    for what a data axis does not run (the prefix cache) names the
    multi-card item (a data slice runs: tests/test_torch_mesh_data.py)."""
    from repro_torch.configs import reduced
    cfg = reduced(get_config("opt-1.3b"))
    ecfg = EngineConfig(max_batch=2, kv_pool_tokens=256, max_model_len=64)
    cluster = ReplicatedCluster.sliced(cfg, None, ecfg,
                                       make_test_mesh("cpu"), 1)
    assert cluster.n_replicas == 1
    two = make_mesh((2, 1), ("data", "model"), ["cpu", "cpu"])
    assert ReplicatedCluster.sliced(cfg, None, ecfg, two, 2).n_replicas == 2
    with pytest.raises(NotImplementedError, match="more than one card"):
        ReplicatedCluster.sliced(cfg, None, dataclasses.replace(
            ecfg, prefix_cache=True), two, 1)
