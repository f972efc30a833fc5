"""Failure/repair events, the health ledger and the training session
(port of `repro.runtime`: the binary events, `plan_from_health` and
`NTPSession` at pp=1)."""
from repro_torch.core.nonuniform import FailurePlan  # noqa: F401
from repro_torch.core.ntp_train import Mode, NTPModelConfig  # noqa: F401
from repro_torch.runtime.events import (  # noqa: F401
    ClusterHealth, DeadReplicaError, FailureEvent, LifecycleEvent,
    RecoveryEvent, event_kind, plan_from_health, resolve_serving_domain,
)
from repro_torch.runtime.session import NTPSession  # noqa: F401
