"""The port's dry-run against the JAX reference's cases, on the CPU: for
every arch x shape on the 1 x 1 and both production meshes,
``build_case`` gives the reference's skips, adjusted ``sliding_window``
and ``q_block``, rule flags, batch specs, per-device argument bytes,
``model_flops`` and ``donate`` (the reference's cases built on an
``AbstractMesh``, nothing compiled); ``apply_variant`` and
``adjusted_cfg`` as the reference's; ``dryrun --all`` with no error, the
reference's record keys and every argument on the meta device; the
per-device census on a 1 x 1 mesh equal to the whole step's with no
collective, the sharded products halved by a doubled model axis, and
the dry-run's decode and prefill steps equal to the serving steps'
census (``step_census`` with its live attention terms); and
reduced cases materialized on the CPU, run through their step, against
the reference's step (decode across a ring wrap, a prefill)."""
import ast
import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.registry import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.core.hardware import Hardware as JHardware  # noqa: E402
from repro.launch import input_specs as JI  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ALL, get_config, reduced  # noqa: E402
from repro_torch.core import census as C  # noqa: E402
from repro_torch.core.census import (StepShape,  # noqa: E402
                                     dryrun_census)
from repro_torch.core.hardware import Hardware  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import input_specs as TI  # noqa: E402
from repro_torch.launch.mesh import (MULTI_CARD_ITEM, make_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models.params import (cache_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.sharding import rules_for  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the thresholds at the reference's budget: a Hardware of 16e9 bytes in
# both packages (the port has no TPU entry)
J_HW = JHardware("test-16gb", 1e12, 1e12, 1e9, 16e9)
T_HW = Hardware("test-16gb", 1e12, 1e12, 1e9, 16e9)
NAME = "internlm2-1.8b"
W = 16


def _moment(arch):
    return "bfloat16" if arch == "arctic-480b" else "float32"


def _j_bytes(shardings, sds):
    sh = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    sd = jax.tree.leaves(sds)
    assert len(sh) == len(sd)
    return float(sum(np.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                     for s, x in zip(sh, sd)))


def _j_outs(jc):
    """The shapes of a reference case's outputs (its step is not traced:
    its ``shard_map`` wants the mesh installed)."""
    B, S, V = jc.shape.batch, jc.shape.seq, jc.cfg.vocab_size
    f32 = jnp.float32
    if jc.shape.kind == "train":
        scalar = jax.ShapeDtypeStruct((), f32)
        return (jc.args_sds[0], jc.args_sds[1],
                {"loss": scalar, "grad_norm": scalar})
    if jc.cfg.arch_type == "encoder":
        return jax.ShapeDtypeStruct((B, S, V), f32)
    kv = min(S, jc.cfg.sliding_window or S)
    return (jax.ShapeDtypeStruct((B, V), f32),
            JM.cache_sds(jc.cfg, B, kv))


@pytest.mark.parametrize("arch", sorted(J_ASSIGNED))
def test_build_case_matches_reference(arch, monkeypatch):
    """Skips, adjusted config, rule flags, batch specs, per-device
    argument bytes, model FLOPs and donation equal the reference's; every
    argument is a meta tensor."""
    monkeypatch.setattr(JI, "TPU_V5E", J_HW)
    for shape in JI.SHAPES:
        for mesh_name, (dims, axes) in MESHES.items():
            jm, tm = AbstractMesh(dims, axes), make_mesh(dims, axes)
            kw = dict(moment_dtype=_moment(arch))
            try:
                jc = JI.build_case(arch, shape, jm, **kw)
            except JI.SkipCase:
                with pytest.raises(TI.SkipCase):
                    TI.build_case(arch, shape, tm, hw=T_HW, **kw)
                continue
            tc = TI.build_case(arch, shape, tm, hw=T_HW, **kw)
            where = (arch, shape, mesh_name)
            for field in ("sliding_window", "q_block", "n_heads",
                          "attn_row_parallel"):
                assert getattr(tc.cfg, field) == getattr(jc.cfg, field), \
                    (where, field)
            for flag in ("shard_kv_seq", "fsdp", "act_replicated",
                         "batch_axes", "model_axis"):
                assert getattr(tc.rules, flag) == getattr(jc.rules, flag), \
                    (where, flag)
            assert tc.donate == jc.donate, where
            assert tc.model_flops == pytest.approx(jc.model_flops,
                                                   rel=1e-12), where
            arg = TD.case_memory(tc)["argument_bytes"]
            assert arg == _j_bytes(jc.in_shardings, jc.args_sds), where
            assert TD.case_memory(tc)["output_bytes"] == _j_bytes(
                jc.out_shardings, _j_outs(jc)), where
            batch_i = {"train": 2, "prefill": 1}.get(tc.shape.kind)
            if batch_i is not None:
                jb = jc.in_shardings[batch_i]
                assert {k: tuple(v.spec) for k, v in jb.items()} == \
                    tc.specs[batch_i], where
            else:
                assert tuple(jc.in_shardings[2].spec) == tc.specs[2]
            for t, _ in TD.leaf_pairs(tc.args, tc.specs):
                assert t.is_meta, where


def test_one_device_fitting_decode_cases():
    """On a 1 x 1 mesh, the decode cases whose predicted peak fits the
    H100 are the six the chip phase runs, with the reference's argument
    bytes (its cases on the same mesh)."""
    fits = []
    jm = AbstractMesh((1, 1), ("data", "model"))
    for arch in J_ASSIGNED:
        for shape in ("decode_32k", "long_500k"):
            rec = TD.run_case(arch, shape, "1x1", None, verbose=False,
                              dispatched=False)
            if rec["status"] != "ok":
                continue
            jc = JI.build_case(arch, shape, jm)
            assert rec["memory"]["argument_bytes"] == _j_bytes(
                jc.in_shardings, jc.args_sds)
            if rec["fits_hbm"]:
                fits.append((arch, shape))
    assert sorted(fits) == sorted([
        ("deepseek-coder-33b", "long_500k"), ("phi3-mini-3.8b", "long_500k"),
        ("internlm2-1.8b", "long_500k"), ("qwen2.5-3b", "long_500k"),
        ("mamba2-1.3b", "long_500k"), ("mamba2-1.3b", "decode_32k")])


def test_variants_and_adjusted_cfg_match_reference():
    """``apply_variant`` over every variant and ``adjusted_cfg`` over every
    arch x shape give the reference's configs (``tests/test_variants.py``'s
    table included); the port raises where the reference refuses."""
    fields = ("n_heads", "attn_kv_repeat", "attn_row_parallel",
              "sliding_window", "q_block")
    for arch in J_ASSIGNED:
        for shape in JI.SHAPES.values():
            for shards in (1, 16, 32):
                j = JI.adjusted_cfg(arch, shape, shards)
                t = TI.adjusted_cfg(arch, TI.SHAPES[shape.name], shards)
                assert [getattr(t, f) for f in fields] == \
                    [getattr(j, f) for f in fields], (arch, shape.name)
        for variant in JI.VARIANTS:
            try:
                j = JI.apply_variant(j_get_config(arch), variant)
            except AssertionError:
                with pytest.raises(ValueError):
                    TI.apply_variant(get_config(arch), variant)
                continue
            t = TI.apply_variant(get_config(arch), variant)
            assert [getattr(t, f) for f in fields] == \
                [getattr(j, f) for f in fields], (arch, variant)
    assert TI.VARIANTS == JI.VARIANTS
    cfg = get_config("arctic-480b")
    assert TI.apply_variant(cfg, None) is cfg
    with pytest.raises(ValueError):
        TI.apply_variant(cfg, "bogus")
    assert TI.adjusted_cfg("phi3-mini-3.8b",
                           TI.SHAPES["long_500k"]).sliding_window == 8192
    assert TI.adjusted_cfg("mamba2-1.3b",
                           TI.SHAPES["long_500k"]).sliding_window is None


def _reference_record_keys():
    """The keys the reference's ``run_case`` writes (read from its
    source: importing it would set up 512 host devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  None) == "update":
            keys.update(k.arg for k in node.keywords)
        if isinstance(node, ast.Dict):
            keys.update(k.value for k in node.keys
                        if isinstance(k, ast.Constant))
    return keys


def test_dryrun_all_prices_every_case(tmp_path, capsys):
    """``dryrun --all`` exits 0 with 76 cases priced and hubert's four
    decode cases skipped; each record has the reference's keys but its
    two CPU-artifact keys, and its memory the reference's four."""
    assert TD.main(["--all", "--out", str(tmp_path)]) == 0
    assert "done: 76 ok, 4 skip, 0 error" in capsys.readouterr().out
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 80
    want = _reference_record_keys() - {"cpu_upcast_artifact_bytes",
                                       "peak_bytes_tpu_adjusted"}
    for rec in recs:
        if rec["status"] == "skip":
            assert rec["arch"] == "hubert-xlarge"
            continue
        assert set(rec) - {"microbatches", "dispatched",
                           "dispatched_needs"} == want - {
                               "reason", "error", "traceback"}
        # no per-device program without the sharded model
        assert rec["dispatched"] == "not measured"
        assert rec["dispatched_needs"] == MULTI_CARD_ITEM
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "peak_bytes"}
        m = rec["memory"]
        assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
        assert rec["fits_hbm"] == (m["peak_bytes"] <= 80e9)


@pytest.mark.parametrize("shape", list(TI.SHAPES))
def test_one_device_census_equals_the_whole_step(shape):
    """On a 1 x 1 mesh the per-device census equals the whole step's,
    class by class, with no collective bytes."""
    one = make_mesh((1, 1), ("data", "model"))
    for arch in J_ASSIGNED:
        try:
            case = TI.build_case(arch, shape, one)
        except TI.SkipCase:
            continue
        step = TD.case_step(case)
        dev = dryrun_census(case.cfg, step, case.rules)
        whole = dryrun_census(case.cfg, step)
        assert dev.coll_bytes == 0 and not dev.per_collective
        assert dev.flops == whole.flops and dev.bytes == whole.bytes
        assert {k: (v.flops, v.bytes) for k, v in dev.per_class.items()} \
            == {k: (v.flops, v.bytes) for k, v in whole.per_class.items()}


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_doubling_the_model_axis_halves_the_sharded_products(kind):
    """internlm2-1.8b's heads, d_ff and vocab divide 2 and 4: every
    weight product is sharded on the model axis, so its FLOPs halve when
    the axis doubles; an all-reduce follows the row-parallel products.
    A prefill's and a train step's ``head`` also holds the embedding's
    elementwise work (``rows·(d + 6)`` a pass, as ``step_census`` files
    it), which the model axis does not divide."""
    cfg = get_config(NAME)
    step = StepShape(kind, 8, 1024, kv_len=1024)
    out = {}
    for m in (2, 4):
        rules = rules_for(make_mesh((1, m), ("data", "model")),
                          fsdp=kind == "train")
        out[m] = dryrun_census(cfg, step, rules)
    embed = 0.0 if kind == "decode" else \
        8 * 1024 * (cfg.d_model + 6) * (C.TRAIN_PASSES if kind == "train"
                                        else 1)
    for cls, fixed in (("matmul", 0.0), ("head", embed)):
        assert out[2].per_class[cls].flops - fixed == \
            pytest.approx(2 * (out[4].per_class[cls].flops - fixed),
                          rel=1e-12)
    assert out[2].per_collective["all-reduce"] > 0


def _by_class(census):
    return {k: (v.flops, v.bytes) for k, v in census.per_class.items()
            if v.flops or v.bytes}


@pytest.mark.parametrize("arch,kind", [
    (a, k) for k in ("decode", "prefill") for a in ALL
    if k == "decode" or get_config(a).causal])
def test_dryrun_census_equals_step_census(arch, kind):
    """Where a dry-run step is a serving step, the two censuses agree
    class by class: a decode step of 4 rows at position 99 over 128
    cache slots is the paged decode step with no block table (its live
    attention 4 x 100 tokens); a prefill of one 64-token prompt is the
    serial prefill's bucket of 64. A VLM's serving decode step first
    gathers each row's image K/V out of its slot (read and written once
    more); its dry-run step reads them in place."""
    cfg = get_config(arch)
    if kind == "decode":
        rows, reads = 4, 100
        dry = dryrun_census(cfg, StepShape("decode", rows, reads,
                                           kv_len=128))
        bucket = (rows, 8)
        live = C.LiveWork(rows=rows, context=rows * reads)
    else:       # an encoder has no serving prefill step
        dry = dryrun_census(cfg, StepShape("prefill", 1, 64))
        bucket = (64,)
        live = C.LiveWork(rows=64, context=0)
    serve = C.with_attention(C.step_census(cfg, kind, bucket, 16),
                             C.attention_cost(cfg, kind, bucket, live, 16))
    got, want = _by_class(dry), _by_class(serve)
    n_cross = C.layer_counts(cfg)["cross"]
    if kind == "decode" and n_cross:
        gather = 2 * rows * cfg.n_img_tokens * 2 * cfg.n_kv_heads * cfg.hd \
            * C.itemsize(cfg) * n_cross
        flops, nbytes = want["attention"]
        want["attention"] = (flops, nbytes - gather)
    assert set(got) == set(want)
    for cls in want:
        assert got[cls] == pytest.approx(want[cls], rel=1e-12), cls
    assert not dry.per_collective


# ------------------------------------------------ materialized on the CPU --
_REF = {}


def _reference(window=W):
    """The reference's reduced config and the port's, float32."""
    if window not in _REF:
        jcfg = dataclasses.replace(j_reduced(j_get_config(NAME)),
                                   sliding_window=window)
        tcfg = dataclasses.replace(reduced(get_config(NAME)),
                                   sliding_window=window)
        _REF[window] = (jcfg, tcfg)
    return _REF[window]


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=atol)


def _materialized(cfg, shape):
    mesh = make_test_mesh("cpu")
    case = TI.case_for(cfg, shape, mesh)
    args = TI.materialize(case, mesh, torch.Generator().manual_seed(0))
    held = sum(t.numel() * t.element_size()
               for t, _ in TD.leaf_pairs(args, case.specs))
    assert held == TD.case_memory(case)["argument_bytes"]
    return case, args


def test_materialized_decode_across_a_ring_wrap_equals_reference(rules):
    """A reduced long-context decode case (a ring of 16 slots, position
    39: wrapped twice) materialized on the CPU: its step's logits and the
    cache it writes equal the reference's ``decode_step`` on the same
    weights and cache."""
    jcfg, tcfg = _reference()
    case, (params, cache, tokens, pos) = _materialized(
        tcfg, TI.ShapeSpec("long", "decode", 40, 2))
    assert int(pos) == 39 and cache["k"].shape[2] == W
    jp = params_to_numpy(tcfg, params)
    jcache = {"stack": [{n: cache[n].numpy().copy() for n in ("k", "v")}],
              "rem": []}
    jl, jc = JM.decode_step(jp, jcfg, rules, jcache,
                            jnp.asarray(tokens.numpy()), jnp.int32(39))
    logits, out = case.fn(params, cache, tokens, pos)
    _close(logits, jl, 1e-4)
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    for name in ("k", "v"):
        _close(out[name], want[name], 1e-5)


def test_materialized_prefill_equals_reference(rules):
    """A reduced prefill case (prompts of 24 over a window of 16, so the
    returned cache is a ring): logits and cache equal the reference's
    ``prefill``."""
    jcfg, tcfg = _reference()
    case, (params, batch) = _materialized(
        tcfg, TI.ShapeSpec("p", "prefill", 24, 2))
    jl, jc, _ = JM.prefill(params_to_numpy(tcfg, params), jcfg, rules,
                           {"tokens": jnp.asarray(batch["tokens"].numpy())},
                           cache_len=W)
    logits, cache = case.fn(params, batch)
    _close(logits, jl, 1e-4)
    want = cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    for name in ("k", "v"):
        _close(cache[name], want[name], 1e-5)


def test_materialized_train_step_runs():
    """A reduced train case materialized on the CPU takes a step: a finite
    loss, the parameters and moments updated in place, the step 1."""
    _, tcfg = _reference()
    case, (params, opt, batch) = _materialized(
        tcfg, TI.ShapeSpec("t", "train", 16, 4))
    before = params["embed"]["tok"].clone()
    new_params, new_opt, metrics = case.fn(params, opt, batch)
    assert torch.isfinite(metrics["loss"]) and int(new_opt[2]) == 1
    assert new_params["embed"]["tok"].data_ptr() == \
        params["embed"]["tok"].data_ptr()
    assert not torch.equal(params["embed"]["tok"], before)


def test_materialize_refuses_more_than_one_device():
    _, tcfg = _reference()
    two = make_mesh((1, 2), ("data", "model"), ["cpu", "cpu"])
    case = TI.case_for(tcfg, TI.ShapeSpec("long", "decode", 40, 2), two)
    # a decode case runs over two devices under its own rules, as a rank
    with pytest.raises(ValueError, match="needs a rank"):
        TI.materialize(case, two, torch.Generator())
    train = TI.case_for(tcfg, TI.ShapeSpec("t", "train", 16, 4), two)
    with pytest.raises(NotImplementedError, match="more than one card"):
        TI.materialize(train, two, torch.Generator(), rank=0)
    with pytest.raises(ValueError, match="real devices"):
        TI.materialize(case, make_mesh((1, 1), ("data", "model")),
                       torch.Generator())
