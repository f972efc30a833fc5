"""Goodput model the allocator optimizes (port of
`repro/cluster/goodput.py`; numpy only): relative cluster samples/step of a
candidate failure-count layout, before any plan exists.

It works on raw per-(stage, domain) failed counts rather than
`FailurePlan`s, so dead layouts (a replica at TP 0 in some stage) are
representable: their goodput is 0 for the affected replica, which is what
makes rescue moves come out first. The per-replica math is the stack the
runtime meters itself with: per-stage packing, slowest-stage gating and
`policies.replica_throughput`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.policies import WorkloadGeometry, replica_throughput
from repro_torch.core.power import PowerModel


@dataclass(frozen=True)
class GoodputModel:
    """Relative goodput (1.0 = pristine) of a per-stage failed-count layout.

    ``step_time_s`` converts goodput deltas into wall seconds for the
    allocator's amortization gate (seconds of useful compute recovered per
    step = Δgoodput × step_time_s); `for_perf` derives it from the analytic
    perf model.
    """

    n1: int                       # scale-up domain size (full TP)
    geom: WorkloadGeometry = field(default_factory=WorkloadGeometry)
    method: str = "ntp"           # "ntp" | "ntp_pw" (replica_throughput)
    power: PowerModel = field(default_factory=PowerModel)
    step_time_s: float = 1.0

    @classmethod
    def for_perf(cls, hw, wl, par, *, geom: WorkloadGeometry = None,
                 method: str = "ntp",
                 power: PowerModel = None) -> "GoodputModel":
        """Bind step time to `perf_model.iteration_time` at full health."""
        from repro_torch.core.perf_model import iteration_time

        step = iteration_time(hw, wl, par)["total"]
        return cls(n1=par.tp, geom=geom or WorkloadGeometry(),
                   method=method, power=power or PowerModel(),
                   step_time_s=float(step))

    # ------------------------------------------------------------ evaluation

    def effective_tp(self, counts: Sequence[np.ndarray]) -> np.ndarray:
        """Per-replica effective TP of a candidate layout: each stage packs
        its failures independently (most-failed first, `pack_replicas`'
        order), and 1F1B gates every replica at its slowest stage. May
        contain zeros (dead replicas), which callers price at goodput 0."""
        packed = np.stack([
            np.sort(np.asarray(c, dtype=int))[::-1] for c in counts
        ])
        return self.n1 - packed.max(axis=0)

    def replica_degradations(self, counts: Sequence[np.ndarray],
                             degradations=None):
        """Per-replica merged `DomainDegradation` of a candidate layout, or
        None when every site is clear (the binary fast path).

        Each stage's ledger follows the most-failed-first packing order
        `effective_tp` prices (stable descending argsort, deterministic on
        ties), and 1F1B merges across stages: a replica inherits the worst
        straggle / weakest link of every domain it spans."""
        if degradations is None or all(d is None for d in degradations):
            return None
        from repro_torch.runtime.events import DomainDegradation

        merged = [DomainDegradation() for _ in counts[0]]
        clear = True
        for c, degs in zip(counts, degradations):
            if degs is None:
                continue
            order = np.argsort(-np.asarray(c, dtype=int), kind="stable")
            for r, dom in enumerate(order):
                dg = degs[int(dom)]
                if dg is not None and not dg.clear:
                    merged[r] = merged[r].merge(dg)
                    clear = False
        return None if clear else tuple(merged)

    def goodput(self, counts: Sequence[np.ndarray],
                degradations=None) -> float:
        """Mean relative replica throughput of the layout (0..1).

        ``degradations`` (per-stage sequences of Optional `DomainDegradation`
        aligned with ``counts``) weights each replica by its ledger: a
        straggling domain drags its replica through `replica_throughput`'s
        slow_factor, a weak link through bw_frac, and an uncleared SDC
        suspicion prices the replica at 0 (quarantined until the clear)."""
        tps = self.effective_tp(counts)
        degs = self.replica_degradations(counts, degradations)
        if degs is None:
            return float(np.mean([
                replica_throughput(int(t), self.n1, self.geom, self.method,
                                   self.power)
                for t in tps
            ]))
        return float(np.mean([
            0.0 if dg.sdc > 0 else
            replica_throughput(int(t), self.n1, self.geom, self.method,
                               self.power, slow_factor=dg.slow_factor,
                               bw_frac=dg.bw_frac)
            for t, dg in zip(tps, degs)
        ]))

    def gain_seconds(self, delta_goodput: float, horizon_steps: int) -> float:
        """Useful-compute seconds a goodput delta recovers over the horizon."""
        return delta_goodput * self.step_time_s * horizon_steps
