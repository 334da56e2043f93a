"""The port's dispatch census (``repro_torch.core.analysis``, the
counterpart of ``repro.core.analysis``) on the CPU: ``classify`` against
the reference's on every rule and on composite names; the byte, FLOP,
launch and temporary rules on hand cases, exact, on CPU and meta
tensors; each kernel wrapper counted as one launch of its static cost,
its plain version's operations uncounted; and served steps of OPT-1.3B
and qwen2.5-3b (GQA), reduced, against the reference's HLO census of the
same buckets (``matmul`` and ``head`` FLOPs within 0.1%, the tolerance
``tests/test_torch_obs.py`` holds the analytic census to), equal on CPU
and meta tensors, at least the analytic census's bytes; and the dry-run's
one-device record."""
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import analysis as J  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Observability as JObservability  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import analysis as A  # noqa: E402
from repro_torch.core import census as C  # noqa: E402
from repro_torch.core.hardware import H100_SXM5_80GB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_cost, gqa_decode_attention)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, attended_pairs, flash_attention, flash_cost,
    flash_prefix_attention, flash_prefix_cost)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_cost, paged_gqa_decode_attention)
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, sharegpt_like)
from repro_torch.serving.obs.observer import Observability  # noqa: E402

DEVICES = ("cpu", "meta")
BS = 8
BASE = dict(max_batch=4, block_size=BS, kv_pool_tokens=4096,
            max_model_len=128, prefill_bucket=16)
ARCHS = ("opt-1.3b", "qwen2.5-3b")


def _on(dev, *shapes, dtype=torch.float32):
    """Seeded tensors of ``shapes`` on ``dev`` (meta: no data)."""
    g = torch.Generator().manual_seed(0)
    out = [torch.randn(s, generator=g, dtype=torch.float32).to(dtype)
           for s in shapes]
    return [t.to(dev) for t in out]


def _classes(d):
    return {k: (v.flops, v.bytes, d.launches.per_class.get(k, 0))
            for k, v in d.census.per_class.items()}


# ---------------------------------------------------------------- classes --
COMPOSITE = ("", "jit(step)/while/body/qkv_proj/dot_general",
             "layer/mlp/attn_core", "moe_gather/expert_ffn", "router",
             "decode/ssm_state_update", "ssd_intra/mlp", "embed/logits",
             "loss", "cross_kv", "cross_attn/attn_out", "kv_update/mlp",
             "something_else")


@pytest.mark.parametrize("name", [p for p, _ in J._CLASS_RULES]
                         + list(COMPOSITE))
def test_classify_matches_reference(name):
    assert A.classify(name) == J.classify(name)


def test_class_rules_are_the_references():
    assert A._CLASS_RULES == J._CLASS_RULES


def test_scopes_nest_and_label_profiler_ranges():
    """A scope pushes its name for the census and, only while a profiler
    runs, opens a range of the same name."""
    assert A.scope_path() == ""
    with A.scope("layer"), A.scope("mlp"):
        assert A.scope_path() == "layer/mlp"
        assert A.classify(A.scope_path()) == "matmul"
    assert A.scope_path() == ""
    x = torch.ones(4, 4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with A.scope("attn_core"):
            x @ x
    assert "attn_core" in {e.name for e in prof.events()}


# -------------------------------------------------------------- hand cases --
@pytest.mark.parametrize("dev", DEVICES)
def test_scoped_linear_relu_add(dev):
    """``addmm`` counts 2MNK and its bias adds, the inputs (the weight's
    transpose a view) and the output once; the ReLU and the add their
    elements; everything under ``mlp`` is ``matmul``, the rest
    ``other``."""
    x, w, b = _on(dev, (4, 8), (16, 8), (16,))

    def f():
        with A.scope("mlp"):
            h = torch.relu(torch.nn.functional.linear(x, w, b))
        return h + h

    d = A.census_of(f)
    isz = 4
    assert _classes(d) == {
        "matmul": (2 * 4 * 8 * 16 + 4 * 16 + 4 * 16,
                   (4 * 8 + 16 * 8 + 16 + 4 * 16) * isz + 2 * 4 * 16 * isz,
                   2),
        "other": (4 * 16, 2 * 4 * 16 * isz, 1)}
    assert d.census.coll_bytes == 0 and d.launches.total == 3


@pytest.mark.parametrize("dev", DEVICES)
def test_views_count_nothing(dev):
    (x,) = _on(dev, (8, 6))
    d = A.census_of(lambda: x.view(6, 8).t()[1:3].unsqueeze(0)
                    .expand(5, 2, 6).transpose(1, 2))
    assert d.census.bytes == d.census.flops == d.launches.total == 0
    assert d.temp_bytes == 0


@pytest.mark.parametrize("dev", DEVICES)
def test_gather_counts_twice_its_output(dev):
    (table,) = _on(dev, (1000, 8))
    idx = torch.tensor([3, 1, 4, 1, 5]).to(dev)
    for fn in (lambda: table.index_select(0, idx), lambda: table[idx],
               lambda: torch.nn.functional.embedding(idx, table)):
        d = A.census_of(fn)
        assert _classes(d) == {"other": (5 * 8, 2 * 5 * 8 * 4, 1)}


@pytest.mark.parametrize("dev", DEVICES)
def test_scatter_counts_twice_the_update_never_the_pool(dev):
    pool, src = _on(dev, (4096, 16), (3, 16))
    idx = torch.tensor([7, 2, 9]).to(dev)
    with A.DispatchCensus() as cen:
        with A.scope("kv_update"):
            pool.index_copy_(0, idx, src)
            pool.index_put_((idx,), src)
    d = cen.result()
    assert _classes(d) == {"attention": (0.0, 2 * 2 * 3 * 16 * 4, 2)}


@pytest.mark.parametrize("dev", DEVICES)
def test_in_place_counts_its_operand_once(dev):
    a, b = _on(dev, (10,), (10,))
    d = A.census_of(lambda: a.add_(b))
    assert _classes(d) == {"other": (10, 2 * 10 * 4, 1)}
    assert d.temp_bytes == 0             # nothing allocated


@pytest.mark.parametrize("dev", DEVICES)
def test_temp_peak_over_a_known_chain(dev):
    """The peak counts what the call allocated and holds at once: two
    1024-float tensors, never the argument, a view or a freed one."""
    (x,) = _on(dev, (1024,))

    def chain():
        y = x * 2
        z = (y + 1).view(32, 32)
        del y
        w = z * 3
        del z
        return w - 1

    d = A.census_of(chain)
    assert d.temp_bytes == 2 * 1024 * 4
    assert d.launches.total == 4


# ---------------------------------------------------------------- kernels --
def _wrapper_cases(dev, dtype):
    """(name, the call, its census cost) of every kernel wrapper at a
    small GQA shape."""
    B, K, G, hd, BS_, nb, S = 3, 2, 2, 64, 16, 4, 40
    H = K * G
    q, kp, vp, k, v, qs, ks, vs = _on(
        dev, (B, H, hd), (9, BS_, K, hd), (9, BS_, K, hd), (B, S, K, hd),
        (B, S, K, hd), (B, 24, H, hd), (B, 32, K, hd), (B, 32, K, hd),
        dtype=dtype)
    table = torch.randint(0, 9, (B, nb), dtype=torch.int32).to(dev)
    lens = torch.tensor([5, 40, 17], dtype=torch.int32).to(dev)
    fl = dict(causal=True, window=None, lengths=lens)
    pre = dict(prefix_pad=8, prefix_len=5, lengths=lens)
    return [
        ("paged_decode_attention",
         lambda: paged_gqa_decode_attention(q, kp, vp, table, lens),
         paged_cost(q, kp, vp, table, lens)),
        ("decode_attention", lambda: gqa_decode_attention(q, k, v, lens),
         decode_cost(q, k, v, lens)),
        ("flash_attention", lambda: flash_attention(qs, ks, vs, **fl),
         flash_cost(qs, ks, vs, **fl)),
        ("flash_attention",
         lambda: FlashAttentionFn.apply(qs, ks, vs, True, None, lens, 128,
                                        128),
         flash_cost(qs, ks, vs, **fl)),
        ("flash_prefix_attention",
         lambda: flash_prefix_attention(qs, ks, vs, **pre),
         flash_prefix_cost(qs, ks, vs, **pre)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i", range(5))
def test_kernel_wrapper_is_one_launch_of_its_static_cost(i, dtype):
    """Each wrapper is one ``attention`` launch of its kernel with the
    cost its static shapes give, its plain version's operations uncounted;
    its output held as a temporary, its scratch at the peak. The meta path
    returns the same shape and dtype with the same census."""
    got = {}
    for dev in DEVICES:
        name, call, cost = _wrapper_cases(dev, dtype)[i]
        with A.DispatchCensus() as cen:
            out = call()
        d = cen.result()
        assert d.launches.kernels == {name: 1} and d.launches.total == 1
        assert cen.ops == {("attention", name): 1}
        assert _classes(d) == {"attention": (cost.flops, cost.bytes, 1)}
        assert d.temp_bytes == max(out.numel() * out.element_size(),
                                   cost.scratch)
        got[dev] = (d, out.shape, out.dtype)
    assert got["cpu"] == got["meta"]


def test_kernel_costs_by_hand():
    """The static costs: the paged kernel reads every row its table can
    address, the contiguous one the padded cache, flash q, k, v and out
    once; FLOPs 4 hd a head and a pair."""
    q, kp, vp = _on("meta", (3, 4, 64), (9, 16, 2, 64), (9, 16, 2, 64))
    table = torch.empty((3, 4), dtype=torch.int32, device="meta")
    lens = torch.empty((3,), dtype=torch.int32, device="meta")
    c = paged_cost(q, kp, vp, table, lens)
    rows = 3 * 4 * 16
    assert c.flops == 4 * rows * 4 * 64
    assert c.bytes == 2 * rows * 2 * 64 * 4 + 2 * 3 * 4 * 64 * 4 + 4 * 15
    assert attended_pairs(4, 4, True, None) == 10
    assert attended_pairs(4, 6, False, None) == 24
    assert attended_pairs(5, 5, True, 2) == 9
    assert attended_pairs(3, 7, True, None, offset=4) == 18


# ------------------------------------------------------------ served steps --
@pytest.fixture(scope="module")
def served(rules):
    """Each arch served on both engines with observers, the same weights
    and requests; the reference's census cache and the port's engine and
    observer."""
    out = {}
    for arch in ARCHS:
        jcfg = j_reduced(j_get_config(arch))
        tcfg = reduced(get_config(arch))
        jp = j_init_params(jcfg, jax.random.PRNGKey(0))
        jmodel = JModel(jcfg, rules)
        jobs = JObservability()
        jeng = JEngine(jmodel, jp, JEngineConfig(**BASE),
                       steps=JStepFunctions.build(jmodel, BS))
        jobs.attach(jeng)
        jeng.run(j_sharegpt_like(3, 512, seed=3, mean_in=12, mean_out=6,
                                 max_len=40, sigma=0.4))
        model = Model(tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jp), device="cpu"), device="cpu")
        eng = ContinuousBatchingEngine(model, EngineConfig(**BASE),
                                       device="cpu")
        obs = Observability(hw=H100_SXM5_80GB, strict_census=True)
        ob = obs.attach(eng)
        eng.run(sharegpt_like(3, 512, seed=3, mean_in=12, mean_out=6,
                              max_len=40, sigma=0.4))
        want = {(v, tuple(key)): sc
                for (v, _, key), sc in jobs.census._cache.items()}
        out[arch] = (want, eng, obs, ob)
    return out


def _step_key(variant, bucket):
    """The steps' graph key of a census bucket (a greedy serve)."""
    return {"decode": (*bucket, False), "prefill": ("prefill", *bucket)
            }[variant]


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatched_flops_match_reference_hlo_census(served, arch):
    """At every decode and prefill bucket both engines met, the
    dispatched ``matmul`` and ``head`` FLOPs are the reference's HLO
    census's within 0.1%; neither counts a collective."""
    want, eng, obs, _ = served[arch]
    got = obs.census._cache
    assert set(got) == set(want)
    assert {v for v, _ in got} == {"decode", "prefill"}
    for key, jsc in want.items():
        d = got[key].dispatched
        for cls in ("matmul", "head"):
            assert d.census.per_class[cls].flops == pytest.approx(
                jsc.census.per_class[cls].flops, rel=1e-3), (key, cls)
        assert d.census.coll_bytes == jsc.census.coll_bytes == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_bucket_dispatched_equal_on_meta(served, arch):
    """Every bucket of the serve has a dispatched census, equal class by
    class (FLOPs, bytes, launches) and in its temporaries to the same
    body's census on the steps' meta twin."""
    _, eng, obs, _ = served[arch]
    twin = eng.steps.meta_twin()
    assert next(iter(twin.model.params["embed"].values())).is_meta
    for (variant, bucket), sc in obs.census._cache.items():
        d = sc.dispatched
        assert d is not None, (variant, bucket)
        m = A.census_of(twin.body(_step_key(variant, bucket)))
        assert _classes(m) == _classes(d), (variant, bucket)
        assert m.census == d.census and m.temp_bytes == d.temp_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatched_bytes_at_least_the_analytic(served, arch):
    """The dispatched ``matmul`` and ``head`` bytes are at least the
    analytic census's (which counts each activation once), the kernels'
    launches one a layer a step, and the live report carries the
    dispatched census."""
    _, eng, obs, ob = served[arch]
    layers = eng.cfg.n_layers
    for (variant, bucket), sc in obs.census._cache.items():
        d = sc.dispatched
        for cls in ("matmul", "head"):
            assert d.census.per_class[cls].bytes >= \
                sc.census.per_class[cls].bytes, (variant, bucket, cls)
        kernel = {"decode": "paged_decode_attention",
                  "prefill": "flash_attention"}[variant]
        assert d.launches.kernels == {kernel: layers}
    rep = ob.roofline.report("decode")
    assert rep.dispatched is obs.census._cache[
        ("decode", ob.roofline.latest["decode"].key)].dispatched


def test_step_launches_are_the_wrappers_calls(served, monkeypatch):
    """A step's census counts a kernel launch exactly where the model
    calls a wrapper (counted by a pass-through stand-in), and no
    operation of the plain version under ``attn_core``."""
    _, eng, obs, _ = served["opt-1.3b"]
    calls = []
    real = ops.paged_gqa_decode_attention

    def counting(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(ops, "paged_gqa_decode_attention", counting)
    # the newest decode step's bucket: its fields are still staged
    bucket = obs.observer(0).roofline.latest["decode"].key
    with A.DispatchCensus() as cen:
        eng.steps.body(_step_key("decode", bucket))()
    assert cen.result().launches.kernels == {
        "paged_decode_attention": len(calls)} and len(calls) == \
        eng.cfg.n_layers
    args = _wrapper_args()
    with A.DispatchCensus() as cen:
        with A.scope("attn_core"):
            real(*args)
    assert dict(cen.ops) == {("attention", "paged_decode_attention"): 1}


def _wrapper_args():
    q, kp, vp = _on("cpu", (2, 4, 64), (5, 8, 2, 64), (5, 8, 2, 64))
    return (q, kp, vp, torch.zeros((2, 2), dtype=torch.int32),
            torch.tensor([3, 9], dtype=torch.int32))


# ---------------------------------------------------------------- dry-run --
def test_one_device_run_case_records_a_dispatched_census():
    """A 1 x 1 case records its step's dispatch census on meta tensors:
    a contiguous kernel launch a layer, no collective, its FLOPs within
    1% of the dry-run's census, and its temporaries."""
    rec = TD.run_case("qwen2.5-3b", "long_500k", "1x1", None, verbose=False)
    assert rec["status"] == "ok"
    d = rec["dispatched"]
    cfg = get_config("qwen2.5-3b")
    assert d["kernel_launches"] == {"decode_attention": cfg.n_layers}
    assert d["coll_bytes"] == 0 and d["temp_bytes"] > 0
    assert d["launches"] == sum(c["launches"]
                                for c in d["per_class"].values())
    assert d["flops"] == pytest.approx(rec["flops_per_chip"], rel=1e-2)
    assert TD.run_case("qwen2.5-3b", "long_500k", "1x1", None,
                       verbose=False, dispatched=False).get(
                           "dispatched") is None


def test_dryrun_census_and_dispatched_share_classes():
    """``OpCensus`` and ``ClassCost`` have one definition: the analytic
    census's are the dispatch census's."""
    assert C.OpCensus is A.OpCensus and C.ClassCost is A.ClassCost
