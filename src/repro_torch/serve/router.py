"""Request routing for NTP serving: SLO-aware admission, dispatch and
per-replica goodput accounting (live), and the analytic serving-goodput
model (port of `repro/serve/router.py`).

The analytic half replays the same `core.failure_model.simulate_events`
traces the training orchestrator replays: at each sampled instant the
per-domain failed counts give every (domain-pinned) serving replica its
weakest domain's TP, each policy maps that to a relative decode rate —
``drop`` loses the whole replica (loss ∝ its blast radius:
domains_per_replica × domain_size GPUs per single failure), ``ntp``
serves on at 1/slowdown, ``ntp_pw`` boosts survivors through
`policies.boosted_operating_point` — and goodput and SLO attainment
follow.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch import telemetry
from repro_torch.core.availability import ClusterSpec
from repro_torch.core.failure_model import FailureTraceConfig, simulate_events
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


# ---------------------------------------------------------------------------
# live router

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
            return self._reject("too_long")
        if req.deadline is not None:
            rate = self.session.total_rate()
            speed = max(
                (e.rel_speed for e in self.session.engines if not e.dead),
                default=0.0,
            )
            if rate <= 0 or speed <= 0:
                return self._reject("no_capacity")
            # queue wait at aggregate rate + the request's own SERIAL decode
            predicted = (self.now + self.backlog_tokens() / rate
                         + req.remaining / speed)
            if predicted > req.deadline:
                return self._reject("slo_miss_predicted")
        self.queue.append(req)
        telemetry.get().counter("serve.admission", outcome="admitted")
        return True

    def _reject(self, reason: str) -> bool:
        self.rejected += 1
        telemetry.get().counter("serve.admission", outcome="rejected",
                                reason=reason)
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
        tel = telemetry.get()
        if tel.enabled:
            # TTFT at router-tick granularity: the first tick after which a
            # request has emitted any token
            for e in self.session.engines:
                for r in e.in_flight:
                    if r.generated and r.first_token_time is None:
                        r.first_token_time = self.now
        for r in done:
            r.finish_time = self.now
            self.completed.append(r)
            if tel.enabled:
                if r.first_token_time is None:
                    r.first_token_time = self.now
                tel.hist("serve.ttft", r.first_token_time - r.arrival)
                decode_toks = max(1, len(r.generated) - 1)
                tel.hist("serve.tpot",
                         (r.finish_time - r.first_token_time) / decode_toks)
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
        tel = telemetry.get()
        if tel.enabled:
            for r, g in enumerate(per):
                tel.gauge("serve.replica_goodput", g, replica=str(r))
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


# ---------------------------------------------------------------------------
# analytic serving-goodput model

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


def _cluster_point(
    counts: np.ndarray,
    spec: ClusterSpec,
    method: str,
    *,
    slo_slowdown: float,
    geom: WorkloadGeometry,
    power: PowerModel,
) -> Tuple[float, float]:
    """(goodput, slo_attainment) of one failure sample. Replicas are pinned
    to their ``domains_per_replica`` consecutive domains (no serving-time
    repack: the KV state lives there); the weakest domain pins the
    replica, as it pins a PP stage."""
    dpr = spec.domains_per_replica
    n_rep = len(counts) // dpr
    worst = np.asarray(counts)[: n_rep * dpr].reshape(n_rep, dpr).max(axis=1)
    tp = spec.domain_size - worst
    speeds = np.array([
        replica_serve_speed(int(t), spec.domain_size, method,
                            geom=geom, power=power)[0]
        for t in tp
    ])
    total = float(speeds.sum())
    goodput = total / n_rep
    if total <= 0.0:
        return goodput, 0.0
    # traffic routes ∝ capacity; a request meets its latency SLO iff its
    # replica's per-token slowdown stays within the budget
    ok = speeds >= 1.0 / slo_slowdown - 1e-9
    return goodput, float(speeds[ok].sum() / total)


def serving_goodput_trace(
    spec: ClusterSpec,
    trace_cfg: FailureTraceConfig,
    methods: Sequence[str] = ("drop", "ntp", "ntp_pw"),
    *,
    slo_slowdown: float = 1.1,
    sample_every_h: float = 6.0,
    geom: WorkloadGeometry = SERVE_GEOM,
    power: PowerModel = PowerModel(),
) -> Dict[str, Dict[str, float]]:
    """Trace-mean serving goodput and SLO attainment per policy over one
    Llama3-calibrated failure/recovery trace."""
    ev = simulate_events(trace_cfg)
    n_dom = trace_cfg.n_gpus // trace_cfg.domain_size
    times = np.arange(0.0, trace_cfg.days * 24.0, sample_every_h)
    out: Dict[str, Dict[str, List[float]]] = {
        m: {"goodput": [], "slo_attainment": []} for m in methods
    }
    # one arrival-sorted scan over the whole trace
    all_counts = ev.failed_counts_scan(times, n_dom, trace_cfg.domain_size)
    for counts in all_counts:
        for m in methods:
            g, a = _cluster_point(
                counts, spec, m, slo_slowdown=slo_slowdown, geom=geom,
                power=power,
            )
            out[m]["goodput"].append(g)
            out[m]["slo_attainment"].append(a)
    return {
        m: {k: float(np.mean(v)) for k, v in d.items()}
        for m, d in out.items()
    }


def blast_radius_goodput(
    base_spec: ClusterSpec,
    trace_cfg: FailureTraceConfig,
    radii: Sequence[int] = (1, 2, 4, 8),
    methods: Sequence[str] = ("drop", "ntp_pw"),
    *,
    slo_slowdown: float = 1.1,
    sample_every_h: float = 6.0,
    geom: WorkloadGeometry = SERVE_GEOM,
    power: PowerModel = PowerModel(),
) -> Dict[int, Dict[str, float]]:
    """Goodput against the replica blast radius (domains_per_replica):
    under ``drop`` one GPU failure forfeits domains_per_replica ×
    domain_size GPUs of serving capacity, so the loss grows ∝ the radius;
    the NTP policies keep it to the failed domain's slowdown."""
    out: Dict[int, Dict[str, float]] = {}
    for dpr in radii:
        spec = ClusterSpec(
            n_gpus=base_spec.n_gpus, domain_size=base_spec.domain_size,
            domains_per_replica=dpr,
        )
        res = serving_goodput_trace(
            spec, trace_cfg, methods, slo_slowdown=slo_slowdown,
            sample_every_h=sample_every_h, geom=geom, power=power,
        )
        out[dpr] = {m: res[m]["goodput"] for m in methods}
    return out
