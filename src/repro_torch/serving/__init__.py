"""Continuous-batching serving on the paged KV pool (the port's slice of
``repro.serving``), and replicated serving over it."""
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa
                                        EngineConfig, RequestTooLarge)
from repro_torch.serving.metrics import Percentiles, ServingMetrics  # noqa
from repro_torch.serving.workload import (Request, RequestState,  # noqa
                                          SamplingParams,
                                          long_short_workload,
                                          repetitive_workload,
                                          shared_prefix_workload,
                                          sharegpt_like)
from repro_torch.serving.faults import (FAULT_KINDS, FaultInjector,  # noqa
                                        FaultSpec, InjectedFault,
                                        parse_fault)
from repro_torch.serving.cluster import (ClusterMetrics,  # noqa
                                         ReplicatedCluster, autoscale)
