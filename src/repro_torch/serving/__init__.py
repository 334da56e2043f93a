"""Continuous-batching serving on the paged KV pool (the port's slice of
``repro.serving``)."""
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa
                                        EngineConfig, RequestTooLarge)
from repro_torch.serving.metrics import Percentiles, ServingMetrics  # noqa
from repro_torch.serving.workload import (Request, RequestState,  # noqa
                                          SamplingParams, sharegpt_like)
