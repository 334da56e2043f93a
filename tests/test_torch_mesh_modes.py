"""Every engine mode over a mesh's model axis: the overlapped executor,
chunked prefill, the prefix cache, speculation and the gather mode, each
served by the port's tensor-parallel engine on 2 gloo ranks (and the
overlapped, chunked one on 4) against the JAX reference engine in the
same mode on one device, on the same weights (the reference's init
carried across as numpy) and the same requests.

Each rank is a process of its own (``repro_torch.distributed.spawn``);
one spawn a mesh size runs every mode's serve in turn
(``tensor_parallel.run_jobs``), and the reference serves four times
(its engines share one ``StepFunctions``), so the file runs in well
under two minutes alone."""
import functools

import pytest

torch = pytest.importorskip("torch")
# tier-1 runs in several worker processes at once: one intra-op thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.compat import make_mesh as j_make_mesh  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import StepFunctions as JStepFunctions  # noqa: E402
from repro.serving import repetitive_workload as j_repetitive  # noqa: E402
from repro.serving import sharegpt_like as j_sharegpt_like  # noqa: E402
from repro.serving import \
    shared_prefix_workload as j_shared_prefix  # noqa: E402
from repro.sharding import rules_for as j_rules_for  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import tensor_parallel as TP  # noqa: E402
from repro_torch.serving import (EngineConfig, SamplingParams,  # noqa: E402
                                 repetitive_workload, sharegpt_like,
                                 shared_prefix_workload)

ENGINE = dict(max_batch=4, block_size=8, kv_pool_tokens=1024,
              max_model_len=96, prefill_bucket=16)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
# speculation's sampled rows: a low temperature and top-k, so that some
# drafts are accepted on random weights
SPEC_SAMPLED = dict(temperature=0.5, top_k=3, top_p=0.9)


def _sharegpt(ref):
    """8 ShareGPT-shaped requests with Poisson arrivals; every other one
    sampled (its own seed)."""
    make, params = ((j_sharegpt_like, JSamplingParams) if ref
                    else (sharegpt_like, SamplingParams))
    reqs = make(8, 512, seed=5, mean_in=14, mean_out=12, max_len=40,
                sigma=0.5, arrival_rate=200.0)
    return [type(r)(r.req_id, r.prompt, arrival_s=r.arrival_s,
                    sampling=params(**SAMPLED, seed=100 + i,
                                    max_new_tokens=r.max_new_tokens)
                    if i % 2 else r.sampling)
            for i, r in enumerate(reqs)]


def _sharegpt_at_once(ref):
    """:func:`_sharegpt`'s requests, all arrived at t=0: admission then
    follows the batch's free slots alone, not the host's clock, so both
    engines run the same decode steps."""
    return [type(r)(r.req_id, r.prompt, arrival_s=0.0, sampling=r.sampling)
            for r in _sharegpt(ref)]


def _shared_prefix(ref):
    """Two tenants of four requests, a 32-token prefix each."""
    make = j_shared_prefix if ref else shared_prefix_workload
    return make(2, 4, 512, prefix_len=32, suffix_len=12, max_new_tokens=6,
                seed=0)


def _repetitive(ref):
    """Six repetitive prompts, the odd ones sampled."""
    make, params = ((j_repetitive, JSamplingParams) if ref
                    else (repetitive_workload, SamplingParams))
    reqs = make(6, 512, prompt_len=32, max_new_tokens=16, repeat_rate=1.0,
                phrase_len=8, pool_size=1, seed=3)
    return [type(r)(r.req_id, r.prompt, arrival_s=r.arrival_s,
                    sampling=params(**SPEC_SAMPLED, seed=200 + i,
                                    max_new_tokens=r.max_new_tokens)
                    if i % 2 else r.sampling)
            for i, r in enumerate(reqs)]


# the reference's four serves: (workload, engine settings)
REFERENCE = {
    "chunked": (_sharegpt, dict(prefill_chunk_tokens=16, overlap=True)),
    "prefix": (_shared_prefix, dict(prefix_cache=True)),
    "speculate": (_repetitive, dict(speculate=True)),
    "gather": (_sharegpt_at_once, dict(decode_mode="gather")),
}
# each mode over the mesh: (the reference serve it equals, the port's
# settings). The reference's overlapped loop gives its sync loop's tokens
# (its own tests hold that), so one reference serve answers both the
# overlapped and the sync chunked serves
MODES = {
    "overlap": ("chunked", dict(overlap=True, prefill_chunk_tokens=16)),
    "chunked": ("chunked", dict(prefill_chunk_tokens=16)),
    "prefix": ("prefix", dict(prefix_cache=True)),
    "speculate": ("speculate", dict(speculate=True)),
    "gather": ("gather", dict(decode_mode="gather")),
}
# the mode served on 4 ranks too
FOUR = "overlap"


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = j_reduced(j_get_config("opt-1.3b"))
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    return jcfg, reduced(get_config("opt-1.3b")), jp


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference engine's serve ``name`` on one device: each
    request's tokens and finish reason, and its counters."""
    jcfg, _, jp = _weights()
    make, kw = REFERENCE[name]
    reqs = make(True)
    eng = JEngine(_jmodel(), jp, JEngineConfig(**ENGINE, **kw),
                  steps=_jsteps())
    eng.run(reqs)
    counters = dict(decode_samples=len(eng.itl_samples),
                    spec_steps=eng.spec_steps,
                    spec_drafted=eng.spec_drafted,
                    spec_accepted=eng.spec_accepted)
    if eng.prefix is not None:
        counters["prefix_hit_tokens"] = eng.prefix.stats.hit_tokens
    return ([list(map(int, r.output_tokens)) for r in reqs],
            [r.finish_reason for r in reqs], counters)


@functools.lru_cache(maxsize=None)
def _jmodel():
    jcfg, _, _ = _weights()
    return JM.Model(jcfg, j_rules_for(j_make_mesh((1, 1),
                                                   ("data", "model"))))


@functools.lru_cache(maxsize=None)
def _jsteps():
    return JStepFunctions.build(_jmodel(), ENGINE["block_size"])


@functools.lru_cache(maxsize=None)
def _ranks(m):
    """One spawn of ``m`` gloo ranks serving each mode in turn (at 4
    ranks, :data:`FOUR` alone), collectives recorded."""
    _, tcfg, jp = _weights()
    names = list(MODES) if m == 2 else [FOUR]
    jobs = []
    for name in names:
        ref, kw = MODES[name]
        make = REFERENCE[ref][0]
        jobs.append((TP.serve_rank, (tcfg, EngineConfig(**ENGINE, **kw),
                                     make(False), jp), dict(record=True)))
    ranks = D.spawn(TP.run_jobs, D.devices_mesh(m, "cpu"), jobs)
    return {name: [r[j] for r in ranks] for j, name in enumerate(names)}


def _serve(name, m=2):
    return _ranks(m)[name]


# -------------------------------------------------------------- tokens --
@pytest.mark.parametrize("name", list(MODES))
def test_mode_gives_the_reference_engines_tokens(name):
    """Rank 0's tokens and finish reasons over 2 ranks equal the
    reference engine's serve in the same mode on one device."""
    serve = _serve(name)
    tokens, finish, _ = _reference(MODES[name][0])
    assert serve[0]["tokens"] == tokens
    assert serve[0]["finish"] == finish


def test_four_ranks_give_the_reference_engines_tokens():
    """The overlapped, chunked serve over 4 ranks (each holding one head
    and one KV head): the reference's tokens and finish reasons."""
    serve = _serve(FOUR, 4)
    tokens, finish, _ = _reference(MODES[FOUR][0])
    assert serve[0]["tokens"] == tokens
    assert serve[0]["finish"] == finish
    assert serve[0]["chunks"] > serve[0]["prefills"] == 0


@pytest.mark.parametrize("name,m", [(name, 2) for name in MODES]
                         + [(FOUR, 4)])
def test_every_rank_issues_the_same_collectives(name, m):
    """The lock step in every mode: each rank's collectives (op, shape,
    dtype) through the serve, and its kernel launches and graphs, equal
    rank 0's; every body issued its embedding's, 2 a layer and the
    logits' gather."""
    serve = _serve(name, m)
    a = serve[0]["record"]
    assert len(a) > 0
    for r in serve[1:]:
        assert r["record"] == a
        assert r["launches"] == serve[0]["launches"]
        assert r["graphs"] == serve[0]["graphs"] == []
    _, tcfg, _ = _weights()
    assert len(a) % (2 + 2 * tcfg.n_layers) == 0
    bodies = len(a) // (2 + 2 * tcfg.n_layers)
    assert sum(op == "all_gather" for op, _, _ in a) == bodies


# ------------------------------------------------------------- counters --
def test_chunked_and_overlapped_serves_chunk_alike():
    """Chunked prefill over the mesh chunks as on one device: the
    overlapped and the sync serves run the same chunks, suffix chunks
    among them, and no whole-prompt prefill."""
    over, sync = _serve("overlap")[0], _serve("chunked")[0]
    for s in (over, sync):
        assert s["prefills"] == 0 and s["suffix_prefills"] > 0
    assert over["chunks"] == sync["chunks"]
    assert over["suffix_prefills"] == sync["suffix_prefills"]


def test_prefix_cache_hits_as_the_reference():
    """The prefix index lives on rank 0 alone and matches as the
    reference's: the same prefill tokens served from the cache."""
    serve = _serve("prefix")[0]
    _, _, counters = _reference("prefix")
    assert serve["prefix_hit_tokens"] == counters["prefix_hit_tokens"] > 0
    assert serve["suffix_prefills"] > 0


def test_speculation_drafts_and_accepts_as_the_reference():
    """Rank 0's drafter and acceptance: the reference's verify steps,
    drafted and accepted tokens; each verify step ran its ``K_pad + 1``
    decode iterations on every rank."""
    serve = _serve("speculate")[0]
    _, _, counters = _reference("speculate")
    for key in ("spec_steps", "spec_drafted", "spec_accepted"):
        assert serve[key] == counters[key], key
    assert serve["spec_accepted"] > 0
    assert serve["verify_iterations"] > serve["spec_steps"]


def test_gather_decodes_through_the_dense_copy():
    """The gather mode's decode steps, one a decode sample of the
    reference's serve, and every request's first token from a whole
    prefill."""
    serve = _serve("gather")[0]
    _, _, counters = _reference("gather")
    assert serve["decode_steps"] == counters["decode_samples"] > 0
    assert serve["prefills"] == len(serve["tokens"])
