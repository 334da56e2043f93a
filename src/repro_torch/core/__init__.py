"""The paper's contribution as a first-class feature, for the card:
bottleneck analysis (an analytic per-step census and the roofline), the
Batching Configuration Advisor (Eq. 2), and the replication planner and
co-location simulator (the port of ``repro.core``).

The HLO census (``repro.core.analysis``: ``HloCensus``,
``census_from_compiled``, ``memory_from_compiled``) becomes
:mod:`~repro_torch.core.analysis`: a dispatch census of the operations a
step runs (:class:`DispatchCensus`, :func:`census_of`) in the
reference's kernel classes (:func:`classify`, the models'
:func:`scope`), with launches and the peak of temporaries; its
``cpu_upcast_artifact_bytes`` (an XLA:CPU artefact) has no counterpart.
:mod:`~repro_torch.core.census` computes the same census from the
config (the live roofline's, and the dry-run's per-device census with
its collectives and working set). The hardware table holds the card the
port runs on and the paper's H100, no TPU. :func:`slice_mesh` splits a
mesh as the reference's does, :func:`slice_devices` a list of devices.
"""
from repro_torch.core.hardware import (HARDWARE, H100_PAPER,  # noqa
                                       H100_SXM5_80GB, Hardware,
                                       for_device_name)
from repro_torch.core.analysis import (ClassCost,  # noqa
                                       DispatchCensus, Dispatched,
                                       Launches, OpCensus, census_of,
                                       classify, scope)
from repro_torch.core.census import step_census  # noqa
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
                                          ReplicationPlanner, slice_devices,
                                          slice_mesh)
from repro_torch.core.simulator import (SimResult,  # noqa
                                        replication_sweep, simulate_decode)
from repro_torch.core.intensity import (intensity_sweep,  # noqa
                                        roofline_position)
