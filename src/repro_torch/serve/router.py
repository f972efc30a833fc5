"""Request routing for NTP serving: SLO-aware admission, dispatch and
per-replica goodput accounting, plus the per-replica decode-rate model
(port of the live half of `repro/serve/router.py`; the trace-driven
analytic goodput waits for the failure-model slice)."""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Tuple

from repro_torch.core.policies import (
    WorkloadGeometry, boosted_operating_point, degradation_slowdown,
    stage_slowdown,
)
from repro_torch.core.power import PowerModel
from repro_torch.runtime.events import LifecycleEvent
from repro_torch.serve.engine import Request

# Decode-time workload geometry: at long context the per-token KV read makes
# attention (head-quantized over TP) the dominant cost, flipping training's
# 2/3 MLP FLOP share — decode is attention-⅔ (same stage_slowdown form).
SERVE_GEOM = WorkloadGeometry(n_heads=128, local_batch=8, mlp_flops_share=1 / 3)


class Router:
    """SLO-aware admission + dispatch over a `ServeSession`.

    A request with a deadline is rejected up front when the backlog over
    the cluster's CURRENT aggregate decode rate cannot finish it in time.
    Preempted requests re-enter at the queue head."""

    def __init__(self, session):
        self.session = session
        self.queue: deque = deque()
        self.now = 0.0
        self.submitted = 0
        self.rejected = 0
        self.completed: List[Request] = []
        self._max_len = session.engines[0].max_len

    # ------------------------------------------------------------ admission

    def backlog_tokens(self) -> int:
        q = sum(r.remaining for r in self.queue)
        fl = sum(r.remaining for e in self.session.engines for r in e.in_flight)
        return q + fl

    def submit(self, req: Request) -> bool:
        self.submitted += 1
        req.arrival = self.now
        if len(req.prompt) + req.max_new > self._max_len:
            return self._reject()
        if req.deadline is not None:
            rate = self.session.total_rate()
            speed = max(
                (e.rel_speed for e in self.session.engines if not e.dead),
                default=0.0,
            )
            if rate <= 0 or speed <= 0:
                return self._reject()
            # queue wait at aggregate rate + the request's own SERIAL decode
            predicted = (self.now + self.backlog_tokens() / rate
                         + req.remaining / speed)
            if predicted > req.deadline:
                return self._reject()
        self.queue.append(req)
        return True

    def _reject(self) -> bool:
        self.rejected += 1
        return False

    def requeue(self, reqs: Iterable[Request]) -> None:
        """Preempted requests jump the queue (their KV was sacrificed once
        already)."""
        for r in reversed(list(reqs)):
            if not r.done:
                self.queue.appendleft(r)

    # --------------------------------------------------------------- events

    def apply(self, event: LifecycleEvent) -> None:
        self.requeue(self.session.apply(event))

    # ----------------------------------------------------------------- tick

    def step(self) -> List[Request]:
        """Dispatch whatever fits (fastest replicas first), run one wall
        tick, account completions. Returns this tick's finished requests."""
        engines = sorted(
            self.session.engines, key=lambda e: -e.rel_speed * e.capacity
        )
        for e in engines:
            while self.queue and e.can_admit():
                if not e.admit(self.queue.popleft()):  # pragma: no cover
                    break
        done = self.session.tick()
        self.now += 1.0
        for e in self.session.engines:
            for r in e.in_flight:
                if r.generated and r.first_token_time is None:
                    r.first_token_time = self.now
        for r in done:
            r.finish_time = self.now
            if r.first_token_time is None:
                r.first_token_time = self.now
            self.completed.append(r)
        return done

    def drain(self, max_ticks: int = 10_000) -> None:
        """Run until queue + slots are empty (or the tick budget runs out)."""
        for _ in range(max_ticks):
            if not self.queue and all(
                e.n_active == 0 for e in self.session.engines
            ):
                return
            self.step()
        raise RuntimeError(f"drain did not converge in {max_ticks} ticks")

    # ------------------------------------------------------------ accounting

    def slo_attainment(self) -> float:
        """Fraction of completed requests that met their deadline (no
        deadline counts as met)."""
        if not self.completed:
            return 1.0
        ok = sum(
            1 for r in self.completed
            if r.deadline is None or r.finish_time <= r.deadline
        )
        return ok / len(self.completed)

    def goodput(self) -> Dict:
        """Tokens/tick per replica and overall, plus SLO attainment."""
        ticks = max(self.now, 1.0)
        per = [e.stats["tokens"] / ticks for e in self.session.engines]
        return {
            "per_replica": per,
            "tokens_per_tick": float(sum(per)),
            "slo_attainment": self.slo_attainment(),
            "completed": len(self.completed),
            "rejected": self.rejected,
            "preemptions": sum(
                e.stats["preemptions"] for e in self.session.engines
            ),
        }


def replica_serve_speed(
    tp: int,
    n1: int,
    method: str,
    *,
    geom: WorkloadGeometry = SERVE_GEOM,
    power: PowerModel = PowerModel(),
    slow_factor: float = 1.0,
    bw_frac: float = 1.0,
) -> Tuple[float, float]:
    """(relative decode rate, power boost) of one serving replica whose
    weakest scale-up domain has ``tp`` of ``n1`` GPUs surviving.
    ``slow_factor``/``bw_frac`` fold a domain's degradation in: a
    degraded-but-complete replica is slowed, never dropped; ``ntp_pw``
    boosts the slowdown away up to the rack cap."""
    if tp <= 0:
        return 0.0, 1.0
    if tp >= n1:
        dm = degradation_slowdown(slow_factor, bw_frac, geom)
        if dm == 1.0:
            return 1.0, 1.0
        if method == "ntp_pw":
            p, eff = boosted_operating_point(dm, power)
            return 1.0 / eff, p
        return 1.0 / dm, 1.0
    if method == "drop":
        return 0.0, 1.0
    slow = stage_slowdown(tp, n1, geom,
                          slow_factor=slow_factor, bw_frac=bw_frac)
    if method == "ntp":
        return 1.0 / slow, 1.0
    if method == "ntp_pw":
        p, eff = boosted_operating_point(slow, power)
        return 1.0 / eff, p
    raise ValueError(method)
