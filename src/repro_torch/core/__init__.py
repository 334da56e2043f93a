"""The paper's contribution as a first-class feature, for the card:
bottleneck analysis (an analytic per-step census and the roofline), the
Batching Configuration Advisor (Eq. 2), and the replication planner and
co-location simulator (the port of ``repro.core``).

Three departures from ``repro.core``: :mod:`~repro_torch.core.census`
computes the step census from the config, in place of the HLO census
(``HloCensus``, ``census_from_compiled``, ``memory_from_compiled``);
:func:`slice_devices` splits a list of devices where ``slice_mesh``
split a mesh; and the hardware table holds the card the port runs on and
the paper's H100, no TPU.
"""
from repro_torch.core.hardware import (HARDWARE, H100_PAPER,  # noqa
                                       H100_SXM5_80GB, Hardware,
                                       for_device_name)
from repro_torch.core.census import OpCensus, step_census  # noqa
from repro_torch.core.roofline import (RooflineReport,  # noqa
                                       model_flops_for, roofline_report)
from repro_torch.core.perfmodel import (HostOverhead,  # noqa
                                        ServingCurves, decode_curves,
                                        decode_step_terms, max_batch_for,
                                        prefill_step_terms)
from repro_torch.core.bca import (BatchingConfigurationAdvisor,  # noqa
                                  BCAResult, SpecPlan, audit_sizing,
                                  chunk_budget_for, knee_point,
                                  slo_from_reference, speculation_advisor,
                                  with_prefix_reuse)
from repro_torch.core.replication import (ReplicationPlan,  # noqa
                                          ReplicationPlanner, slice_devices)
from repro_torch.core.simulator import (SimResult,  # noqa
                                        replication_sweep, simulate_decode)
from repro_torch.core.intensity import (intensity_sweep,  # noqa
                                        roofline_position)
