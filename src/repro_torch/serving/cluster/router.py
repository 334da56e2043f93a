"""Request routing across model replicas — pluggable policies (a copy of
``repro.serving.cluster.router``: the same choices on the same loads).

A policy sees the incoming :class:`~repro_torch.serving.workload.Request` and a
sequence of replica handles and returns the index of the replica that
should serve it. Replica handles are duck-typed; a policy may read

* ``queue_depth`` — requests admitted to the replica but still waiting,
* ``in_flight``  — requests currently in the running batch,
* ``load``       — ``queue_depth + in_flight``,
* ``kv_load``    — fraction of the replica's KV pool in use.

Policies are deliberately O(R) and stateless (except round-robin's
counter): the paper's replication gain (Sec. VI-B) comes from the memory
freed by BCA, so the router's job is only to keep replicas evenly loaded —
ties break toward the lowest replica index, which keeps routing
deterministic for the cluster's sync test mode.
"""
from __future__ import annotations

import abc
from collections import OrderedDict
from typing import Dict, List, Sequence, Type, Union

from repro_torch.serving.workload import Request


class RouterPolicy(abc.ABC):
    """Picks a replica index for each arriving request."""

    name: str = "?"

    @abc.abstractmethod
    def choose(self, req: Request, replicas: Sequence) -> int:
        ...

    def reset(self):
        """Forget any routing state (e.g. after a warmup workload)."""


class RoundRobin(RouterPolicy):
    """Cycle through replicas in arrival order — load-blind, zero-cost."""

    name = "round-robin"

    def __init__(self):
        self._next = 0

    def choose(self, req: Request, replicas: Sequence) -> int:
        idx = self._next % len(replicas)
        self._next += 1
        return idx

    def reset(self):
        self._next = 0


class JoinShortestQueue(RouterPolicy):
    """Send to the replica with the fewest admitted-or-running requests —
    the classic JSQ policy; near-optimal tail latency under bursty load."""

    name = "jsq"

    def choose(self, req: Request, replicas: Sequence) -> int:
        return min(range(len(replicas)),
                   key=lambda i: (replicas[i].load, i))


class LeastKVLoad(RouterPolicy):
    """Send to the replica with the most free KV-pool blocks, breaking
    ties by queue length. Long prompts go where they can be admitted
    immediately instead of stalling behind a full pool (the admission
    watermark the engine enforces)."""

    name = "least-kv"

    def choose(self, req: Request, replicas: Sequence) -> int:
        return min(range(len(replicas)),
                   key=lambda i: (replicas[i].kv_load, replicas[i].load, i))


class PrefixAffinity(RouterPolicy):
    """Route prompts sharing a prefix to the replica that cached it.

    Each engine's prefix index is per-replica, so a tenant's shared
    system prompt only pays prefill (and pool blocks) on the replicas it
    actually lands on — spraying one tenant across all R replicas costs
    R cold prefills and R copies of the cached blocks. The policy keeps a
    sticky map from the hash of the first ``affinity_tokens`` prompt
    tokens to a home replica; new keys go to the least-loaded replica
    (JSQ). Affinity must not buy unbounded queueing: when the home
    replica is more than ``max_skew`` requests above the least-loaded
    one, the request (and the key's home) migrate there — the new home
    rebuilds the prefix on first miss and stays local thereafter.

    Deterministic for a fixed arrival order (ties break to the lowest
    index), like the other policies.
    """

    name = "prefix-affinity"

    def __init__(self, affinity_tokens: int = 64, max_skew: int = 8,
                 max_keys: int = 4096):
        self.affinity_tokens = affinity_tokens
        self.max_skew = max_skew
        self.max_keys = max_keys
        self._home: "OrderedDict[bytes, int]" = OrderedDict()

    def choose(self, req: Request, replicas: Sequence) -> int:
        key = req.prompt[:self.affinity_tokens].tobytes()
        loads = [r.load for r in replicas]
        least = min(range(len(replicas)), key=lambda i: (loads[i], i))
        idx = self._home.get(key)
        if idx is not None and idx < len(replicas) \
                and loads[idx] - loads[least] <= self.max_skew:
            self._home.move_to_end(key)
            return idx
        self._home[key] = least
        self._home.move_to_end(key)
        while len(self._home) > self.max_keys:
            self._home.popitem(last=False)
        return least

    def reset(self):
        self._home.clear()


POLICIES: Dict[str, Type[RouterPolicy]] = {
    cls.name: cls for cls in (RoundRobin, JoinShortestQueue, LeastKVLoad,
                              PrefixAffinity)}


def make_policy(policy: Union[str, RouterPolicy]) -> RouterPolicy:
    if isinstance(policy, RouterPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown router policy {policy!r}; "
                         f"available: {sorted(POLICIES)}") from None


class Router:
    """Applies a policy and keeps per-replica assignment counts."""

    def __init__(self, policy: Union[str, RouterPolicy], n_replicas: int):
        self.policy = make_policy(policy)
        self.assigned: List[int] = [0] * n_replicas

    def route(self, req: Request, replicas: Sequence) -> int:
        idx = self.policy.choose(req, replicas)
        if not 0 <= idx < len(replicas):
            raise IndexError(
                f"policy {self.policy.name!r} chose replica {idx} "
                f"of {len(replicas)}")
        # the cluster may pass a filtered (eligible-only) view, so credit
        # the replica's own slot, not its position in the passed list
        slot = getattr(replicas[idx], "idx", idx)
        if 0 <= slot < len(self.assigned):
            self.assigned[slot] += 1
        return idx

    def reset(self):
        self.policy.reset()
        self.assigned = [0] * len(self.assigned)
