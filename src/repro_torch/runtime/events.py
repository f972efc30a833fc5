"""Failure/repair events and the per-domain failed-GPU ledger (port of the
binary half of `repro/runtime/events.py`).

A `FailureEvent` removes GPUs from a scale-up domain, a `RecoveryEvent`
returns them; `ClusterHealth` keeps the failed count of every domain.
Serving replicas are pinned to their domain, so serving addresses events
through `resolve_serving_domain`. The six degradation kinds (stragglers,
degraded links, SDC suspicion) and the training-side packing wait for
their slices.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union


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

    @property
    def n_domains(self) -> int:
        return len(self.failed)

    @property
    def n_replicas(self) -> int:
        return self.n_domains // self.domains_per_replica

    @property
    def healthy(self) -> bool:
        return all(f == 0 for f in self.failed)

    def apply(self, event: LifecycleEvent) -> "ClusterHealth":
        """Health after a DOMAIN-addressed ``event``. Failures saturate at
        the domain size; repairs saturate at fully healthy. (Replica-
        addressed events resolve through the training packing, which is not
        ported yet; serving resolves them with `resolve_serving_domain`.)"""
        if event.stage not in (None, 0):
            raise ValueError(
                f"{type(event).__name__} addresses pipeline stage "
                f"{event.stage}, but this health ledger is single-stage"
            )
        domain = event.domain
        if domain is None:
            raise ValueError(
                f"{type(event).__name__} is replica-addressed; resolve it to "
                "a domain first (resolve_serving_domain)"
            )
        if not 0 <= domain < self.n_domains:
            raise ValueError(f"no domain {domain}")
        failed = list(self.failed)
        if isinstance(event, RecoveryEvent):
            failed[domain] = max(0, failed[domain] - event.n_gpus)
        elif isinstance(event, FailureEvent):
            failed[domain] = min(self.domain_size,
                                 failed[domain] + event.n_gpus)
        else:
            raise TypeError(f"not a lifecycle event: {type(event).__name__}")
        return replace(self, failed=tuple(failed))


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
