"""Health events, the health ledger, the power policy, trace replay and the
training session (port of `repro.runtime` at pp=1)."""
from repro_torch.core.nonuniform import FailurePlan, StagedPlan, as_staged  # noqa: F401
from repro_torch.core.ntp_train import Mode, NTPModelConfig  # noqa: F401
from repro_torch.runtime.events import (  # noqa: F401
    CLEAR_DEGRADATION, DEGRADATION_EVENTS, EVENT_KIND_NAMES, ClusterHealth,
    DeadReplicaError, DomainDegradation, FailureEvent, HealthEvent,
    HealthState, LifecycleEvent, LinkDegradeEvent, LinkRepairEvent,
    RecoveryEvent, SdcClearEvent, SdcSuspectEvent, StagedHealth,
    StragglerClearEvent, StragglerEvent, event_kind, inverse,
    plan_from_health, resolve_serving_domain, staged_plan_from_health,
)
from repro_torch.runtime.orchestrator import (  # noqa: F401
    PowerDecision, PowerPolicy, ScheduledEvent, TraceRunner,
    power_policy, schedule_from_trace,
)
from repro_torch.runtime.session import NTPSession  # noqa: F401
