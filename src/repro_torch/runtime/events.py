"""Failure/repair events, the per-domain failed-GPU ledger and the bridge
from the resource manager's packing into a `FailurePlan` (port of the
binary half of `repro/runtime/events.py`).

A `FailureEvent` removes GPUs from a scale-up domain, a `RecoveryEvent`
returns them; `ClusterHealth` keeps the failed count of every domain.
Training addresses an event by domain or by replica: a replica-addressed
event lands on that replica's worst domain under the current packing
(`ClusterHealth.resolve_domain`), and `plan_from_health` turns the packed
assignment into the `FailurePlan` the training step consumes. Serving
replicas are pinned to their domain, so serving addresses events through
`resolve_serving_domain`. The six degradation kinds (stragglers, degraded
links, SDC suspicion) and the per-stage ledger wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.nonuniform import FailurePlan
from repro_torch.core.resource_manager import (
    ReplicaAssignment, apply_spares, pack_replicas,
)


class DeadReplicaError(RuntimeError):
    """A replica's every scale-up domain lost all GPUs — NTP cannot keep it
    computing; the job needs DP_DROP or spare domains."""


@dataclass(frozen=True)
class _ClusterEvent:
    """Shared shape of failure/recovery notifications. Exactly one of
    ``domain`` (physical scale-up-domain index) or ``replica`` must identify
    the site. ``stage`` narrows it to one pipeline stage (serving is
    single-stage and rejects it)."""

    step: Optional[int] = None      # step the event was observed at
    domain: Optional[int] = None
    replica: Optional[int] = None
    n_gpus: int = 1                 # GPUs affected in that domain
    stage: Optional[int] = None     # pipeline stage (None = unstaged/pp=1)

    def __post_init__(self):
        if (self.domain is None) == (self.replica is None):
            raise ValueError(
                f"{type(self).__name__} needs exactly one of domain= or replica="
            )
        if self.n_gpus < 1:
            raise ValueError("n_gpus must be >= 1")
        if self.stage is not None and self.stage < 0:
            raise ValueError(f"stage must be >= 0, got {self.stage}")


@dataclass(frozen=True)
class FailureEvent(_ClusterEvent):
    """One failure notification: ``n_gpus`` GPUs lost in the site's
    scale-up domain."""


@dataclass(frozen=True)
class RecoveryEvent(_ClusterEvent):
    """One repair notification — the inverse of `FailureEvent`: ``n_gpus``
    GPUs return to service. Repairing an already-healthy domain is a
    no-op (failed counts saturate at 0)."""


LifecycleEvent = Union[FailureEvent, RecoveryEvent]

_EVENT_KIND = {FailureEvent: "failure", RecoveryEvent: "repair"}


def event_kind(event: LifecycleEvent) -> str:
    """Canonical kind string of ``event``."""
    return _EVENT_KIND[type(event)]


@dataclass(frozen=True)
class ClusterHealth:
    """Failed-GPU counts per physical scale-up domain."""

    domain_size: int
    failed: Tuple[int, ...]
    domains_per_replica: int = 1

    def __post_init__(self):
        if self.domain_size < 1:
            raise ValueError(f"domain_size must be >= 1, got {self.domain_size}")
        if not all(0 <= f <= self.domain_size for f in self.failed):
            raise ValueError(f"failed counts {self.failed} outside "
                             f"[0, {self.domain_size}]")
        if len(self.failed) % self.domains_per_replica:
            raise ValueError("domains do not divide into replicas")

    @classmethod
    def pristine(cls, n_domains: int, domain_size: int,
                 domains_per_replica: int = 1) -> "ClusterHealth":
        return cls(domain_size, (0,) * n_domains, domains_per_replica)

    @classmethod
    def from_plan(cls, plan: FailurePlan) -> "ClusterHealth":
        """One domain per replica, failures as implied by the plan's TPs."""
        return cls(plan.n1, tuple(plan.n1 - t for t in plan.replica_tp))

    @property
    def n_domains(self) -> int:
        return len(self.failed)

    @property
    def n_replicas(self) -> int:
        return self.n_domains // self.domains_per_replica

    @property
    def healthy(self) -> bool:
        return all(f == 0 for f in self.failed)

    def assignments(self) -> List[ReplicaAssignment]:
        """Current packing: most-failed domains into the lowest replicas."""
        return pack_replicas(
            list(self.failed), self.domain_size, self.domains_per_replica
        )

    def resolve_domain(self, event: LifecycleEvent) -> int:
        """Physical domain ``event`` lands on: its explicit ``domain``, or —
        replica-addressed — the worst domain of that replica under the
        CURRENT packing (the domain already pinning its TP)."""
        if event.stage not in (None, 0):
            raise ValueError(
                f"{type(event).__name__} addresses pipeline stage "
                f"{event.stage}, but this health ledger is single-stage "
                "(pp=1) — only stage=None or stage=0 is valid"
            )
        domain = event.domain
        if domain is None:
            asg = self.assignments()
            if not 0 <= event.replica < len(asg):
                raise ValueError(f"no replica {event.replica}")
            a = asg[event.replica]
            domain = int(a.domain_ids[int(np.argmax(a.failed))])
        if not 0 <= domain < self.n_domains:
            raise ValueError(f"no domain {domain}")
        return domain

    def apply(self, event: LifecycleEvent) -> "ClusterHealth":
        """Health after ``event`` (site per `resolve_domain`). Failures
        saturate at the domain size; repairs saturate at fully healthy."""
        if not isinstance(event, (FailureEvent, RecoveryEvent)):
            raise TypeError(f"not a lifecycle event: {type(event).__name__}")
        domain = self.resolve_domain(event)
        failed = list(self.failed)
        if isinstance(event, RecoveryEvent):
            failed[domain] = max(0, failed[domain] - event.n_gpus)
        else:
            failed[domain] = min(self.domain_size,
                                 failed[domain] + event.n_gpus)
        return replace(self, failed=tuple(failed))


def plan_from_health(health: ClusterHealth, *, spares: int = 0) -> FailurePlan:
    """Bridge `pack_replicas` output into a `FailurePlan`.

    Spare domains (paper §3.3) absorb the worst failures first; whatever
    remains is packed and becomes per-replica operating TPs. Raises
    `DeadReplicaError` when packing still leaves a replica at TP 0.
    """
    counts = np.asarray(health.failed)
    if spares:
        counts = apply_spares(counts, spares)
    asg = pack_replicas(counts, health.domain_size, health.domains_per_replica)
    tp = tuple(a.tp for a in asg)
    if any(t == 0 for t in tp):
        raise DeadReplicaError(
            f"replica_tp={tp}: a replica has no surviving GPUs "
            "(use Mode.DP_DROP or add spare domains)"
        )
    return FailurePlan(n1=health.domain_size, replica_tp=tp)


def resolve_serving_domain(event: LifecycleEvent,
                           n_domains: int) -> LifecycleEvent:
    """Normalize an event for DOMAIN-PINNED serving replicas: serving
    replicas are never repacked across domains (the KV state pins them), so
    ``replica=r`` aliases ``domain=r`` 1:1. Returns a domain-addressed event
    of the same type; raises `ValueError` naming the offending id when it
    is outside ``[0, n_domains)``."""
    if event.stage is not None:
        raise ValueError(
            f"{type(event).__name__} addresses pipeline stage {event.stage}, "
            "but serving sessions are single-stage"
        )
    if event.domain is None:
        event = replace(event, domain=event.replica, replica=None)
    if not 0 <= event.domain < n_domains:
        kind = type(event).__name__
        raise ValueError(
            f"{kind} addresses domain {event.domain}, but this serving "
            f"session has {n_domains} domain-pinned replicas "
            f"(valid ids: 0..{n_domains - 1})"
        )
    return event
