"""`GlobalPlan` — the global repack planner's output (port of
`repro/cluster/plan.py`): the final `StagedPlan` the session should run,
plus the audit trail of how the allocator got there (decisions,
transitions, conserved failure counts, goodput before/after, total
predicted traffic)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.cluster.actions import Action
from repro_torch.core.nonuniform import StagedPlan


@dataclass(frozen=True)
class GlobalPlan:
    """One allocator verdict for one `StagedHealth` ledger.

    ``counts`` is the final per-(stage, domain) failed-count layout after
    swaps, with spare-absorbed sites zeroed; with ``spare_sites`` (each
    recording how many failures the spare soaked up) it is meant to
    conserve the ledger's failures. ``staged_plan`` is that layout packed
    per stage. ``predicted_bytes`` prices the single current→final
    transition the session executes; with a cost model calibrated from the
    live trees it equals the executed `TransferStats.bytes_moved`.
    """

    staged_plan: StagedPlan
    actions: Tuple[Action, ...]
    counts: Tuple[Tuple[int, ...], ...]            # per stage, post-decisions
    spare_sites: Tuple[Tuple[int, int, int], ...]  # (stage, domain, absorbed)
    swaps: Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...]
    goodput: float
    baseline_goodput: float                        # stage-local, spare-less
    baseline: Optional[StagedPlan]                 # None: baseline is dead
    predicted_bytes: int
    horizon_steps: int

    @property
    def decisions(self) -> Tuple[Action, ...]:
        return tuple(a for a in self.actions if a.kind != "transition")

    @property
    def transitions(self) -> Tuple[Action, ...]:
        """Ordered state movements executing the plan (stage order)."""
        return tuple(a for a in self.actions if a.kind == "transition")

    @property
    def moved(self) -> bool:
        return self.predicted_bytes > 0

    def summary(self) -> dict:
        return {
            "goodput": self.goodput,
            "baseline_goodput": self.baseline_goodput,
            "spares_used": len(self.spare_sites),
            "swaps": len(self.swaps),
            "predicted_bytes": self.predicted_bytes,
            "stage_tp": tuple(p.replica_tp for p in self.staged_plan.stages),
        }
