"""Typed health events, the cluster health ledger, and the bridge from the
resource manager's packing into a `FailurePlan` — the port's copy of
`repro/runtime/events.py` (host-side, numpy only).

The paper's restart flow (§3.3): a GPU fails somewhere in a scale-up domain;
on restart the resource manager packs partially-failed domains into the
lowest-rank DP replicas and the job resumes with those replicas at reduced
TP. Here that flow is data: a `FailureEvent` updates `ClusterHealth`, and
`plan_from_health()` turns the packed assignment into the `FailurePlan` the
step builder consumes. `RecoveryEvent` is the inverse. Training addresses an
event by domain or by replica (a replica-addressed event lands on that
replica's worst domain under the current packing); serving replicas are
pinned to their domain and go through `resolve_serving_domain`.

Fleets fail *partially* long before they fail outright, so the ledger is a
health-STATE machine: each domain carries a `DomainDegradation` — a multiset
of straggler slow factors, a multiset of link bandwidth fractions, and an
SDC-suspicion counter — updated by the degradation half of the
`HealthEvent` taxonomy (`StragglerEvent`, `LinkDegradeEvent`,
`SdcSuspectEvent` and their inverses via `inverse()`). Multiset semantics
make every inverse EXACT: a clear removes one occurrence of the value its
degrade pushed (effective slow factor = max, effective bandwidth = min), so
float severities round-trip bit-identically. Degradation is orthogonal to
packing — failed counts alone drive `pack_replicas`; the policies consume
the per-replica degradation view. A health with no degradations normalizes
its ``degraded`` field back to ``None``, so binary fail/repair traces replay
bit-identically.

`StagedHealth` and `staged_plan_from_health` are the per-(replica, stage)
ledger of a pipeline-parallel job; the port's session still runs pp=1 only.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, fields, replace
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.nonuniform import FailurePlan, StagedPlan
from repro_torch.core.resource_manager import (
    ReplicaAssignment, apply_spares, pack_replicas,
)


class HealthState(enum.Enum):
    """Dominant health label of one scale-up domain.

    Per-GPU absence is tracked by the failed COUNT (a domain with some GPUs
    down but survivors computing still labels by its dominant *degradation*,
    or HEALTHY — reduced TP is the NTP normal, not a state of its own);
    FAILED means the whole domain is gone. Priority when several conditions
    coexist: FAILED > SDC_SUSPECT > STRAGGLER > LINK_DEGRADED > HEALTHY —
    the order in which the policies act on them (quarantine beats slowdown
    pricing beats comm repricing)."""

    HEALTHY = "healthy"
    FAILED = "failed"
    STRAGGLER = "straggler"
    LINK_DEGRADED = "link_degraded"
    SDC_SUSPECT = "sdc_suspect"


class DeadReplicaError(RuntimeError):
    """A replica's every scale-up domain lost all GPUs — NTP cannot keep it
    computing; the job needs DP_DROP or spare domains."""


@dataclass(frozen=True)
class _ClusterEvent:
    """Shared shape of failure/recovery notifications. Exactly one of
    ``domain`` (physical scale-up-domain index) or ``replica`` (current mesh
    DP index — resolved against the live packing) must identify the site.

    ``stage`` (pipeline-parallel jobs) narrows the site to
    one pipeline stage: ``domain`` then indexes WITHIN that stage's D
    domains. On a staged session an un-staged event resolves to the worst
    (stage, domain) of its site — the stage already pinning the replica's
    TP; on a pp=1 session ``stage`` must be absent or 0."""

    step: Optional[int] = None      # training step the event was observed at
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
    """One failure notification: ``n_gpus`` GPUs lost in the blast site's
    scale-up domain (replica-addressed events land on that replica's worst
    domain under the current packing)."""


@dataclass(frozen=True)
class RecoveryEvent(_ClusterEvent):
    """One repair notification — the inverse of `FailureEvent`: ``n_gpus``
    GPUs return to service. A replica-addressed repair lands on that
    replica's WORST domain (the one pinning its TP). Repairing an
    already-healthy domain is a no-op: failed counts saturate at the domain
    size on the way down, so the way up must absorb the matching surplus
    repairs of a clamped trace."""


@dataclass(frozen=True)
class StragglerEvent(_ClusterEvent):
    """The site's domain is DETECTED slow: its compute runs ``slowdown``×
    slower than spec (thermal throttle, sick HBM, a crashed SM — ByteDance
    taxonomy). The domain keeps its GPUs (no repack); the power policy
    prices it like a TP reduction and the allocator may evict it."""

    slowdown: float = 2.0

    def __post_init__(self):
        super().__post_init__()
        if not self.slowdown > 1.0:
            raise ValueError(
                f"slowdown must be > 1.0 (a {self.slowdown}× straggler is "
                "not a straggler)"
            )


@dataclass(frozen=True)
class StragglerClearEvent(_ClusterEvent):
    """Inverse of `StragglerEvent`: removes ONE occurrence of ``slowdown``
    from the site's straggle multiset (clearing a value that was never
    pushed is absorbed, like surplus repairs)."""

    slowdown: float = 2.0

    def __post_init__(self):
        super().__post_init__()
        if not self.slowdown > 1.0:
            raise ValueError(f"slowdown must be > 1.0, got {self.slowdown}")


@dataclass(frozen=True)
class LinkDegradeEvent(_ClusterEvent):
    """The site's scale-up interconnect is running at ``bw_frac`` of spec
    (lane drop, flapping NVLink/NIC). Comm-bound work slows by 1/bw_frac;
    the effective slow factor blends by the workload's comm share."""

    bw_frac: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        if not 0.0 < self.bw_frac < 1.0:
            raise ValueError(
                f"bw_frac must be in (0, 1), got {self.bw_frac}"
            )


@dataclass(frozen=True)
class LinkRepairEvent(_ClusterEvent):
    """Inverse of `LinkDegradeEvent`: removes one ``bw_frac`` occurrence
    from the site's link multiset (absorbing when absent)."""

    bw_frac: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        if not 0.0 < self.bw_frac < 1.0:
            raise ValueError(f"bw_frac must be in (0, 1), got {self.bw_frac}")


@dataclass(frozen=True)
class SdcSuspectEvent(_ClusterEvent):
    """Silent-data-corruption suspicion raised against the site (mismatched
    checksums, NaN watchdog, duplicate-compute divergence). Counts, does not
    fail: the replica owning the domain is QUARANTINED (batch 0) and rolled
    back to the canonical checkpoint by the session policy."""


@dataclass(frozen=True)
class SdcClearEvent(_ClusterEvent):
    """Inverse of `SdcSuspectEvent`: one suspicion retracted (floor 0)."""


#: The full taxonomy. `LifecycleEvent` remains as the historical alias —
#: every consumer annotated against it accepts the whole state machine.
HealthEvent = Union[
    FailureEvent, RecoveryEvent,
    StragglerEvent, StragglerClearEvent,
    LinkDegradeEvent, LinkRepairEvent,
    SdcSuspectEvent, SdcClearEvent,
]
LifecycleEvent = HealthEvent

#: Events that touch the degradation ledger (not the failed counts).
DEGRADATION_EVENTS = (
    StragglerEvent, StragglerClearEvent, LinkDegradeEvent, LinkRepairEvent,
    SdcSuspectEvent, SdcClearEvent,
)

_INVERSE_KIND = {
    FailureEvent: RecoveryEvent, RecoveryEvent: FailureEvent,
    StragglerEvent: StragglerClearEvent, StragglerClearEvent: StragglerEvent,
    LinkDegradeEvent: LinkRepairEvent, LinkRepairEvent: LinkDegradeEvent,
    SdcSuspectEvent: SdcClearEvent, SdcClearEvent: SdcSuspectEvent,
}

_EVENT_KIND = {
    FailureEvent: "failure", RecoveryEvent: "repair",
    StragglerEvent: "straggler", StragglerClearEvent: "straggler_clear",
    LinkDegradeEvent: "link_degrade", LinkRepairEvent: "link_repair",
    SdcSuspectEvent: "sdc_suspect", SdcClearEvent: "sdc_clear",
}

#: Canonical kind strings, degrade/clear pairs adjacent — the vocabulary
#: telemetry counters and the trace sampler share.
EVENT_KIND_NAMES = tuple(_EVENT_KIND.values())


def event_kind(event: HealthEvent) -> str:
    """Canonical kind string of ``event`` (telemetry/report vocabulary;
    binary events keep their historical "failure"/"repair" names)."""
    return _EVENT_KIND[type(event)]


def inverse(event: HealthEvent) -> HealthEvent:
    """The event that exactly undoes ``event`` at the same site: fail↔repair
    (same ``n_gpus``), straggle↔clear and degrade↔repair (same severity
    value — multiset semantics make the round trip exact), suspect↔clear.
    ``apply(e) ∘ apply(inverse(e))`` is the identity on any health where
    ``inverse(e)`` applies without saturating (the property suite's oracle).
    """
    cls = _INVERSE_KIND[type(event)]
    return cls(**{f.name: getattr(event, f.name) for f in fields(event)})


def _push(values: Tuple[float, ...], v: float) -> Tuple[float, ...]:
    return tuple(sorted(values + (float(v),)))


def _remove_one(values: Tuple[float, ...], v: float) -> Tuple[float, ...]:
    """Remove ONE occurrence of ``v`` (bit-equal float — the clear event
    carries the exact value its degrade pushed); absorb when absent."""
    out = list(values)
    try:
        out.remove(float(v))
    except ValueError:
        pass
    return tuple(out)


@dataclass(frozen=True)
class DomainDegradation:
    """Partial-health ledger of ONE scale-up domain.

    Multisets, not scalars: concurrent degradations stack (two independent
    stragglers in one domain), and each clear removes exactly the value its
    degrade event pushed — so per-kind inverses are exact for float-valued
    severities. Effective factors are worst-of: ``slow_factor`` is the max
    straggle (the slowest GPU gates the TP group), ``bw_frac`` the min link
    fraction (the weakest lane gates the collective)."""

    straggle: Tuple[float, ...] = ()   # sorted slow factors, each > 1
    link: Tuple[float, ...] = ()       # sorted bandwidth fractions, each < 1
    sdc: int = 0                       # outstanding corruption suspicions

    def __post_init__(self):
        if self.straggle != tuple(sorted(self.straggle)) or not all(
                s > 1.0 for s in self.straggle):
            raise ValueError(f"straggle {self.straggle} is not a sorted "
                             "multiset of slow factors > 1")
        if self.link != tuple(sorted(self.link)) or not all(
                0.0 < b < 1.0 for b in self.link):
            raise ValueError(f"link {self.link} is not a sorted multiset of "
                             "bandwidth fractions in (0, 1)")
        if self.sdc < 0:
            raise ValueError(f"sdc must be >= 0, got {self.sdc}")

    @property
    def clear(self) -> bool:
        return not self.straggle and not self.link and self.sdc == 0

    @property
    def slow_factor(self) -> float:
        """Compute slowdown vs spec (1.0 = full speed)."""
        return self.straggle[-1] if self.straggle else 1.0

    @property
    def bw_frac(self) -> float:
        """Scale-up interconnect bandwidth vs spec (1.0 = full)."""
        return self.link[0] if self.link else 1.0

    def merge(self, other: "DomainDegradation") -> "DomainDegradation":
        """Worst-of union — the degradation a REPLICA sees across the
        domains (and stages) it is packed onto."""
        return DomainDegradation(
            straggle=tuple(sorted(self.straggle + other.straggle)),
            link=tuple(sorted(self.link + other.link)),
            sdc=self.sdc + other.sdc,
        )

    def apply(self, event: HealthEvent) -> "DomainDegradation":
        if isinstance(event, StragglerEvent):
            return replace(self, straggle=_push(self.straggle, event.slowdown))
        if isinstance(event, StragglerClearEvent):
            return replace(
                self, straggle=_remove_one(self.straggle, event.slowdown)
            )
        if isinstance(event, LinkDegradeEvent):
            return replace(self, link=_push(self.link, event.bw_frac))
        if isinstance(event, LinkRepairEvent):
            return replace(self, link=_remove_one(self.link, event.bw_frac))
        if isinstance(event, SdcSuspectEvent):
            return replace(self, sdc=self.sdc + 1)
        if isinstance(event, SdcClearEvent):
            return replace(self, sdc=max(0, self.sdc - 1))
        raise TypeError(f"not a degradation event: {type(event).__name__}")


#: The all-clear degradation (shared constant: `DomainDegradation` is frozen).
CLEAR_DEGRADATION = DomainDegradation()


@dataclass(frozen=True)
class ClusterHealth:
    """Failed-GPU counts per physical scale-up domain, plus the per-domain
    degradation ledger of the health-state machine.

    ``degraded`` is ``None`` when NO domain carries any degradation — the
    normalized all-clear — so binary fail/repair histories produce exactly
    the pre-taxonomy value (equality, hash, replay all bit-identical).
    When present it is one ``Optional[DomainDegradation]`` per domain with
    all-clear entries normalized to ``None``. Packing (`assignments`) reads
    only the failed counts: a straggling domain keeps its GPUs and its
    replica; the *policies* consume `replica_degradations()`."""

    domain_size: int
    failed: Tuple[int, ...]
    domains_per_replica: int = 1
    degraded: Optional[Tuple[Optional[DomainDegradation], ...]] = None

    def __post_init__(self):
        if self.domain_size < 1:
            raise ValueError(f"domain_size must be >= 1, got {self.domain_size}")
        if not all(0 <= f <= self.domain_size for f in self.failed):
            raise ValueError(f"failed counts {self.failed} outside "
                             f"[0, {self.domain_size}]")
        if len(self.failed) % self.domains_per_replica:
            raise ValueError("domains do not divide into replicas")
        if self.degraded is not None:
            if len(self.degraded) != len(self.failed):
                raise ValueError("one degradation entry per domain")
            if all(d is None for d in self.degraded) or any(
                    d is not None and d.clear for d in self.degraded):
                raise ValueError(
                    "all-clear degradation must normalize to None")

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
        return all(f == 0 for f in self.failed) and self.degraded is None

    def degradation(self, domain: int) -> DomainDegradation:
        """The domain's degradation (the shared all-clear when none)."""
        if self.degraded is None or self.degraded[domain] is None:
            return CLEAR_DEGRADATION
        return self.degraded[domain]

    def domain_state(self, domain: int) -> HealthState:
        """Dominant `HealthState` label of ``domain`` (priority per the
        enum's docstring)."""
        if self.failed[domain] >= self.domain_size:
            return HealthState.FAILED
        d = self.degradation(domain)
        if d.sdc > 0:
            return HealthState.SDC_SUSPECT
        if d.straggle:
            return HealthState.STRAGGLER
        if d.link:
            return HealthState.LINK_DEGRADED
        return HealthState.HEALTHY

    def domain_states(self) -> Tuple[HealthState, ...]:
        return tuple(self.domain_state(g) for g in range(self.n_domains))

    def replica_degradations(self) -> Tuple[DomainDegradation, ...]:
        """Per-REPLICA degradation under the CURRENT packing: worst-of merge
        over the domains each replica is packed onto. This is the view the
        power policy, the serve retarget, and the allocator's goodput model
        consume (a straggler anywhere in the replica gates its whole TP×PP
        group, same reduction as the min-TP rule)."""
        if self.degraded is None:
            return (CLEAR_DEGRADATION,) * self.n_replicas
        out = []
        for a in self.assignments():
            d = CLEAR_DEGRADATION
            for g in a.domain_ids:
                d = d.merge(self.degradation(int(g)))
            out.append(d)
        return tuple(out)

    def assignments(self) -> List[ReplicaAssignment]:
        """Current packing: most-failed domains into the lowest replicas."""
        return pack_replicas(
            list(self.failed), self.domain_size, self.domains_per_replica
        )

    def resolve_domain(self, event: LifecycleEvent) -> int:
        """Physical domain ``event`` lands on: its explicit ``domain``, or —
        replica-addressed — the worst domain of that replica under the
        CURRENT packing (the domain already pinning its TP: for a failure
        that is where another hit hurts least, for a repair where a fix
        helps most)."""
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
        saturate at the domain size; repairs saturate at fully healthy.
        Degradation events fold into the site's `DomainDegradation`
        (clears absorb when the value is absent, mirroring surplus
        repairs); an all-clear ledger normalizes back to ``None``."""
        domain = self.resolve_domain(event)
        if isinstance(event, DEGRADATION_EVENTS):
            entries = (
                list(self.degraded) if self.degraded is not None
                else [None] * self.n_domains
            )
            d = (entries[domain] or CLEAR_DEGRADATION).apply(event)
            entries[domain] = None if d.clear else d
            if all(e is None for e in entries):
                return replace(self, degraded=None)
            return replace(self, degraded=tuple(entries))
        failed = list(self.failed)
        if isinstance(event, RecoveryEvent):
            failed[domain] = max(0, failed[domain] - event.n_gpus)
        else:
            failed[domain] = min(self.domain_size, failed[domain] + event.n_gpus)
        return replace(self, failed=tuple(failed))


def resolve_serving_domain(event: LifecycleEvent,
                           n_domains: int) -> LifecycleEvent:
    """Normalize an event for DOMAIN-PINNED serving replicas: serving
    replicas are never repacked across domains (the KV state pins them), so
    ``replica=r`` aliases ``domain=r`` 1:1. Returns a domain-addressed event
    of the same type (severity fields kept); raises `ValueError` naming the
    offending id when it is outside ``[0, n_domains)``."""
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


@dataclass(frozen=True)
class StagedHealth:
    """Per-(replica, stage) failed-GPU ledger of a DP×PP×TP job: one
    `ClusterHealth` per pipeline stage, each over the job's D scale-up
    domains. Stage s of the job owns the physical domains
    ``{g : g % pp == s}`` of the global replica-major numbering (replica
    block r holds its pp stage domains contiguously), so a global domain id
    ``g`` addresses ``(stage=g % pp, domain=g // pp)``."""

    stages: Tuple[ClusterHealth, ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError("a staged health needs at least one stage")
        h0 = self.stages[0]
        if not all(
            h.domain_size == h0.domain_size and h.n_domains == h0.n_domains
            and h.domains_per_replica == h0.domains_per_replica
            for h in self.stages
        ):
            raise ValueError(f"stages of different geometry: {self.stages}")

    @classmethod
    def pristine(cls, n_domains: int, domain_size: int, pp: int) -> "StagedHealth":
        return cls(tuple(
            ClusterHealth.pristine(n_domains, domain_size) for _ in range(pp)
        ))

    @classmethod
    def from_plan(cls, plan: StagedPlan) -> "StagedHealth":
        return cls(tuple(ClusterHealth.from_plan(p) for p in plan.stages))

    @property
    def pp(self) -> int:
        return len(self.stages)

    @property
    def domain_size(self) -> int:
        return self.stages[0].domain_size

    @property
    def n_replicas(self) -> int:
        return self.stages[0].n_replicas

    @property
    def healthy(self) -> bool:
        return all(h.healthy for h in self.stages)

    def replica_degradations(self) -> Tuple[DomainDegradation, ...]:
        """Per-replica worst-of merge ACROSS stages: 1F1B runs every
        microbatch through every stage, so a straggler in any stage gates
        the replica — the degradation analogue of the min-over-stages TP."""
        per_stage = [h.replica_degradations() for h in self.stages]
        out = []
        for r in range(self.n_replicas):
            d = CLEAR_DEGRADATION
            for s in range(self.pp):
                d = d.merge(per_stage[s][r])
            out.append(d)
        return tuple(out)

    def _unstaged(self, event: LifecycleEvent) -> LifecycleEvent:
        return replace(event, stage=None)

    def resolve_site(self, event: LifecycleEvent) -> Tuple[int, int]:
        """(stage, domain) the event lands on. Explicit ``stage`` narrows to
        that stage's ledger; a stage-less replica-addressed event lands on
        the replica's WORST (stage, domain) — the stage pinning its TP is
        where a failure hurts least and a repair helps most (same rule as
        `ClusterHealth.resolve_domain`, lifted over stages)."""
        if event.stage is not None:
            if not 0 <= event.stage < self.pp:
                raise ValueError(
                    f"{type(event).__name__} addresses stage {event.stage}, "
                    f"but this job has {self.pp} pipeline stages "
                    f"(valid: 0..{self.pp - 1})"
                )
            ev = self._unstaged(event)
            return event.stage, self.stages[event.stage].resolve_domain(ev)
        if event.domain is not None:
            # stage-less domain address = GLOBAL domain id (replica-major)
            n_global = self.pp * self.stages[0].n_domains
            if not 0 <= event.domain < n_global:
                raise ValueError(
                    f"no global domain {event.domain} "
                    f"(valid: 0..{n_global - 1} = D*pp domains)"
                )
            return event.domain % self.pp, event.domain // self.pp
        # replica-addressed, stage-less: worst (stage, domain) of the replica
        best: Optional[Tuple[int, int, int]] = None   # (-failed, stage, dom)
        ev = self._unstaged(event)
        for s, h in enumerate(self.stages):
            asg = h.assignments()
            if not 0 <= event.replica < len(asg):
                raise ValueError(f"no replica {event.replica}")
            a = asg[event.replica]
            worst = int(np.argmax(a.failed))
            cand = (-int(a.failed[worst]), s, int(a.domain_ids[worst]))
            if best is None or cand < best:
                best = cand
        return best[1], best[2]

    def apply(self, event: LifecycleEvent) -> "StagedHealth":
        """Ledger after ``event``: only the resolved stage's `ClusterHealth`
        changes (stage-local blast radius)."""
        s, domain = self.resolve_site(event)
        ev = replace(event, stage=None, domain=domain, replica=None)
        stages = list(self.stages)
        stages[s] = stages[s].apply(ev)
        return StagedHealth(tuple(stages))


def staged_plan_from_health(
    health: StagedHealth,
    *,
    spares: int = 0,
    allocator=None,
    current: Optional[StagedPlan] = None,
) -> StagedPlan:
    """Per-stage `plan_from_health`: each stage packs its own failures into
    its lowest replicas independently (SPARe-style stage-local packing — no
    cross-stage repair traffic).

    Spare domains with pp > 1 need the GLOBAL allocator — a spare rack can
    stand in for ANY stage, which per-stage packing cannot express. Pass an
    ``allocator`` (`repro_torch.cluster.GreedyAllocator`) to delegate the
    whole joint search (spares, cross-stage swaps, reordering) to it;
    ``current`` is the plan whose state is in place, so the allocator can
    price transitions against it."""
    if allocator is not None and health.pp > 1:
        return allocator.plan(health, spares=spares, current=current).staged_plan
    if spares and health.pp > 1:
        raise ValueError(
            "spare domains with pp > 1 need the global allocator: a spare "
            "can absorb failures in any stage, which per-stage packing "
            "cannot express. Pass --allocator greedy (launch/train.py) or "
            "allocator=repro_torch.cluster.GreedyAllocator(...) to the session."
        )
    return StagedPlan(tuple(
        plan_from_health(h, spares=spares) for h in health.stages
    ))


def plan_from_health(health: ClusterHealth, *, spares: int = 0) -> FailurePlan:
    """Bridge `pack_replicas` output into a `FailurePlan`.

    Spare domains (paper §3.3 / Fig. 7) absorb the worst failures first;
    whatever remains is packed and becomes per-replica operating TPs. Raises
    DeadReplicaError when packing still leaves a replica at TP 0.
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
