"""Continuous-batching serving on the paged KV pool (the port of
``repro.serving``): the engine and its compiled steps, the scheduler and
executor, speculative decoding, replicated serving, the online facade
(:mod:`~repro_torch.serving.api`) and observability.

Every name ``repro.serving`` exports is exported here. The observability
names resolve lazily through :mod:`repro_torch.serving.obs` (see its
docstring for why), so importing this package loads no observability
module until one of them is used.
"""
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa
                                        EngineConfig, RequestTooLarge)
from repro_torch.serving.steps import StepFunctions  # noqa
from repro_torch.serving.workload import (FINISH_ABORT,  # noqa
                                          FINISH_DEADLINE, FINISH_FAILED,
                                          FINISH_LENGTH, FINISH_REASONS,
                                          FINISH_SHED, FINISH_STOP, Request,
                                          RequestState, SamplingParams,
                                          arrival_times, long_short_workload,
                                          repetitive_workload,
                                          shared_prefix_workload,
                                          sharegpt_like)
from repro_torch.serving.faults import (FAULT_KINDS, FaultInjector,  # noqa
                                        FaultSpec, InjectedFault,
                                        parse_fault)
from repro_torch.serving.metrics import (Percentiles,  # noqa
                                         ServingMetrics, collect_from_engine)
from repro_torch.serving.cluster import (ClusterMetrics,  # noqa
                                         ReplicatedCluster, autoscale)
from repro_torch.serving.scheduler import Scheduler, StepPlan  # noqa
from repro_torch.serving.spec import Drafter, PromptLookupDrafter  # noqa
from repro_torch.serving.executor import Executor  # noqa
from repro_torch.serving.api import (AsyncRequestHandle,  # noqa
                                     AsyncServingAPI, GenerationOutput,
                                     RequestHandle, ServingAPI)

_OBS = ("BoundedSeries", "Dashboard", "LiveRoofline", "MemoryGapAuditor",
        "MetricsEmitter", "Observability", "SLO", "SLOMonitor", "StepPhases",
        "Tracer", "WindowAggregator", "default_slos", "lint_prometheus",
        "metrics_from_json", "metrics_to_json", "prometheus_text",
        "validate_chrome_trace")


def __getattr__(name):
    if name in _OBS:
        from repro_torch.serving import obs
        return getattr(obs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
