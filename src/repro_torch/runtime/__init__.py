"""Failure/repair events and the health ledger (port of the serving-facing
part of `repro.runtime`)."""
from repro_torch.runtime.events import (  # noqa: F401
    ClusterHealth, FailureEvent, LifecycleEvent, RecoveryEvent, event_kind,
    resolve_serving_domain,
)
