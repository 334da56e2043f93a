"""Replicated serving (the port of ``repro.serving.cluster``): R
continuous-batching engines co-located on one card, each on its own CUDA
stream with its own KV pool and step graphs (or one a device, sliced),
behind a shared router, with aggregated cluster metrics and an autoscaler
that closes the measured-curves -> BCA -> replication loop (Sec. VI-B)."""
from repro_torch.serving.cluster.autoscale import (AutoscaleDecision,  # noqa
                                                   autoscale, decide,
                                                   measure_curves)
from repro_torch.serving.cluster.cluster import (Replica,  # noqa
                                                 ReplicatedCluster,
                                                 slice_devices)
from repro_torch.serving.cluster.metrics import (ClusterMetrics,  # noqa
                                                 ReplicaStats, aggregate)
from repro_torch.serving.cluster.router import (POLICIES,  # noqa
                                                JoinShortestQueue,
                                                LeastKVLoad, PrefixAffinity,
                                                RoundRobin, Router,
                                                RouterPolicy, make_policy)
