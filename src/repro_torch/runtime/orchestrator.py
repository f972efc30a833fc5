"""Trace-driven failure/recovery orchestration: the full NTP lifecycle
(pristine → degraded → boosted → repaired) replayed against a live
`NTPSession` — the port's copy of `repro/runtime/orchestrator.py`.

Three pieces:

* `PowerPolicy` — the NTP vs NTP-PW decision hook (paper §3.2, Table 1): on
  every lifecycle transition it consults `core.power.PowerModel` to pick each
  replica's power boost and usable local batch, and predicts the job's
  relative iteration time (recorded into step metrics by the session). The
  boost is a decision the step metrics carry; nothing here sets a card's
  power limit.
* `schedule_from_trace` — converts `core.failure_model.simulate_events`
  output (per-event (domain, gpu) placement + recovery times) into a timed
  `ScheduledEvent` list of typed health events for a job-scale cluster (one
  scale-up domain per DP replica).
* `TraceRunner` — replays a schedule against a real session, optionally
  co-training a dense one-copy reference and holding the session to it at
  every step and every transition (the paper's availability story, §2.3 and
  §6.1, as an executable harness).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch import tree as tr
from repro_torch.core import ntp_train as nt
from repro_torch.core.failure_model import (
    KIND_LINK, KIND_SDC, KIND_STRAGGLER, FailureTraceConfig, simulate_events,
)
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.core.policies import (
    WorkloadGeometry, boosted_operating_point, stage_slowdown,
)
from repro_torch.core.power import PowerModel
from repro_torch.runtime.events import (
    DeadReplicaError, FailureEvent, LifecycleEvent, LinkDegradeEvent,
    LinkRepairEvent, RecoveryEvent, SdcClearEvent, SdcSuspectEvent,
    StragglerClearEvent, StragglerEvent, event_kind,
)

POLICY_NAMES = ("ntp", "ntp_pw")


@dataclass(frozen=True)
class PowerDecision:
    """One policy verdict for one `FailurePlan`."""

    method: str                      # "uniform" | "ntp" | "ntp_pw"
    boost: Tuple[float, ...]         # per-replica power multiplier (×TDP)
    local_batches: Tuple[int, ...]   # per-replica usable samples
    rel_iter_time: float             # predicted job iter time (1.0 = healthy)

    @property
    def max_boost(self) -> float:
        return max(self.boost)


@dataclass(frozen=True)
class PowerPolicy:
    """Decides, per lifecycle transition, how degraded replicas keep pace:

    * ``ntp``    — no boost; shrink local batch ∝ surviving TP (paper §3.1).
    * ``ntp_pw`` — repurpose the failed GPUs' power budget (capped at the
      rack's ``max_boost``, §3.2) and keep as much of the full local batch as
      the boosted speed sustains; shrink only past the cap (Table 1).
    """

    name: str = "ntp"
    model: PowerModel = PowerModel()
    geom: Optional[WorkloadGeometry] = None

    def __post_init__(self):
        if self.name not in POLICY_NAMES:
            raise ValueError(f"policy {self.name!r} not in {POLICY_NAMES}")

    def decide(self, plan: FailurePlan, *, local_batch: int,
               geom: Optional[WorkloadGeometry] = None,
               degradations=None) -> PowerDecision:
        """Per-replica operating points for ``plan``. ``degradations`` is
        the optional per-replica `DomainDegradation` view
        (`ClusterHealth.replica_degradations` /
        `StagedHealth.replica_degradations`): stragglers and degraded links
        ride the SAME NTP degrade math as GPU absence — the slow factor
        multiplies the stage slowdown, NTP sheds batch to not straggle,
        NTP-PW boosts the degraded domain's rack first. A
        replica with an open SDC suspicion is QUARANTINED: batch 0, no
        boost — the session rolls it back and it rejoins on the clear."""
        geom = geom or self.geom or WorkloadGeometry()
        geom = replace(geom, local_batch=local_batch)
        n1 = plan.n1
        ntp_lb = plan.local_batch_fraction(local_batch)
        boosts, lbs, rels = [], [], []
        for r, t in enumerate(plan.replica_tp):
            deg = degradations[r] if degradations is not None else None
            if deg is not None and deg.sdc > 0:
                # quarantined: contributes no samples and gates nothing
                boosts.append(1.0)
                lbs.append(0)
                rels.append(0.0)
                continue
            sf = deg.slow_factor if deg is not None else 1.0
            bw = deg.bw_frac if deg is not None else 1.0
            if t == n1 and sf == 1.0 and bw == 1.0:
                boosts.append(1.0)
                lbs.append(local_batch)
                rels.append(1.0)
                continue
            slow = stage_slowdown(t, n1, geom, slow_factor=sf, bw_frac=bw)
            # the un-boosted share: ∝-TP packing for pure GPU absence, the
            # full slowdown floor once degradation compounds it
            base_bs = (int(ntp_lb[r]) if sf == 1.0 and bw == 1.0
                       else min(int(ntp_lb[r]),
                                int(np.floor(local_batch / slow))))
            if self.name == "ntp_pw":
                # shared Table-1 operating point (core/policies.py); shed
                # batch only past the rack cap, and never below the
                # un-boosted share
                p, eff = boosted_operating_point(slow, self.model)
                bs = int(np.clip(np.floor(local_batch / eff),
                                 max(1, base_bs), local_batch))
            else:
                p = 1.0
                eff = slow
                bs = base_bs
            boosts.append(float(p))
            lbs.append(bs)
            rels.append(eff * bs / local_batch)
        degraded = degradations is not None and any(
            not d.clear for d in degradations
        )
        method = "uniform" if plan.healthy and not degraded else self.name
        return PowerDecision(
            method=method, boost=tuple(boosts), local_batches=tuple(lbs),
            rel_iter_time=float(max(rels)),
        )


def power_policy(name: str, *, model: Optional[PowerModel] = None,
                 geom: Optional[WorkloadGeometry] = None) -> PowerPolicy:
    """Factory for the CLI spelling (``ntp`` / ``ntp_pw`` / ``ntp-pw``)."""
    return PowerPolicy(name=name.lower().replace("-", "_"),
                       model=model or PowerModel(), geom=geom)


# ---------------------------------------------------------------------------
# trace -> timed event schedule

@dataclass(frozen=True)
class ScheduledEvent:
    step: int
    event: LifecycleEvent


def schedule_from_trace(
    cfg: FailureTraceConfig, *, steps: int, steps_per_hour: float = 1.0,
    pp: int = 1,
) -> List[ScheduledEvent]:
    """Timed fail/repair schedule for a job whose cluster is described by
    ``cfg`` — one scale-up domain per (DP replica × pipeline stage)
    (``cfg.n_gpus = D × pp × n1``, ``cfg.domain_size = n1``). Every
    simulated failure becomes a domain-addressed `FailureEvent` at its onset
    step and a matching `RecoveryEvent` at its repair step; failures already
    live at step 0 (lead-in) are injected at step 0, and repairs beyond the
    horizon are dropped (the GPU stays down for the rest of the run).

    With ``pp > 1`` the trace's global domain ids follow the replica-major
    numbering of `StagedHealth` (domain ``g`` → stage ``g % pp``, in-stage
    domain ``g // pp``) and events carry an explicit ``stage=`` so the
    session degrades ONLY the stage whose domain was hit.

    A MIXED trace (``cfg.straggler_rate_mult`` etc.) maps
    each degradation interval to its typed onset/clear event pair carrying
    the sampled severity: straggler → `StragglerEvent(slowdown)` /
    `StragglerClearEvent`, link → `LinkDegradeEvent(bw_frac)` /
    `LinkRepairEvent`, sdc → `SdcSuspectEvent` / `SdcClearEvent`. Binary
    traces take the identical code path with kind 0 everywhere."""
    ev = simulate_events(cfg)
    out: List[ScheduledEvent] = []
    for i in range(ev.n_events):
        s0 = max(0, int(np.ceil(ev.start_h[i] * steps_per_hour)))
        s1 = int(np.ceil(ev.end_h[i] * steps_per_hour))
        dom = int(ev.domain[i])
        if s1 <= 0 or s0 >= steps or s1 <= s0:
            continue
        addr = (
            {"domain": dom} if pp == 1
            else {"domain": dom // pp, "stage": dom % pp}
        )
        kind = int(ev.kind[i]) if ev.kind is not None else 0
        if kind == KIND_STRAGGLER:
            sev = {"slowdown": float(ev.severity[i])}
            onset, clear = StragglerEvent, StragglerClearEvent
        elif kind == KIND_LINK:
            sev = {"bw_frac": float(ev.severity[i])}
            onset, clear = LinkDegradeEvent, LinkRepairEvent
        elif kind == KIND_SDC:
            sev = {}
            onset, clear = SdcSuspectEvent, SdcClearEvent
        else:
            sev = {}
            onset, clear = FailureEvent, RecoveryEvent
        out.append(ScheduledEvent(s0, onset(step=s0, **addr, **sev)))
        if s1 < steps:
            out.append(ScheduledEvent(s1, clear(step=s1, **addr, **sev)))
    # clears/repairs before onsets at the same step: a same-step repair can
    # make an otherwise replica-killing failure legal (and never the reverse)
    return sorted(
        out,
        key=lambda e: (e.step, not isinstance(
            e.event,
            (RecoveryEvent, StragglerClearEvent, LinkRepairEvent,
             SdcClearEvent),
        )),
    )


# ---------------------------------------------------------------------------
# lifecycle replay

class TraceRunner:
    """Replays a `ScheduledEvent` list against a live `NTPSession`.

    With ``verify=True`` it co-trains a dense single-logical-copy reference
    (same optimizer, same batches, the session's per-replica sample masks,
    on the session's device, with autograd through
    `ntp_train.make_reference_loss`) and asserts agreement of the loss at
    EVERY step (``atol``) and of the canonical weights at every lifecycle
    transition (``param_atol``, default ``atol``), upward (repair)
    transitions included. Requires a fresh session. AdamW's rsqrt update
    amplifies f32 rounding into ~1e-4 weight deltas per step even with
    identical math, so long AdamW runs need a looser ``param_atol``; SGD is
    tight at any length.

    Step metrics (loss, grad_norm) stay on the device: ``float()`` every
    step would make the host wait for each step's device work. The device
    scalars are kept in the history records and copied to the host as ONE
    stacked tensor every ``drain_every`` steps and at the end of ``run()``
    — callers still see plain floats, with identical values.
    ``verify=True`` drains every step (the per-step loss check needs the
    value).

    When the schedule holds an `SdcSuspectEvent` and the session
    quarantines, the runner takes the session's `snapshot()` before step 0,
    so the suspicion rolls the session back to it; with ``verify=True`` the
    dense reference keeps a host copy of its own step-0 state and rolls back
    to the same point.

    On a process-group session (a `_RankSession`) every process runs the
    same runner: each replays the schedule, keeps the same history and
    goodput gauges and honours ``drain_every`` alike. ``verify=True`` keeps
    the dense reference (and its rollback copy) on global rank 0 only; the
    canonical checks gather replica 0 over its model group (every process
    of replica 0 takes part, replica 1's issue nothing) and rank 0
    compares. On a staged mesh (pp>1 as processes) the same holds with
    replica 0's processes of every stage taking part (each stage's leaves
    broadcast over ``stage``), global rank 0 being stage 0's, and the
    trace's global domain ids replica-major as below.

    With telemetry active every consumed event becomes an
    ``orchestrator.event`` span (phase marks plan → execute → verified; the
    session's ``session.transition`` span nests inside) and every step
    records the ``train.goodput``, ``train.goodput_unboosted`` and
    ``train.goodput_degradation_loss`` gauges.
    """

    def __init__(
        self,
        session,
        schedule: List[ScheduledEvent],
        *,
        verify: bool = False,
        atol: float = 1e-4,
        param_atol: Optional[float] = None,
        on_event: Optional[Callable[[LifecycleEvent, FailurePlan], None]] = None,
        drain_every: int = 16,
    ):
        self.session = session
        self.schedule = sorted(schedule, key=lambda e: e.step)
        self.verify = verify
        self.atol = atol
        self.param_atol = atol if param_atol is None else param_atol
        self.on_event = on_event
        self.history: List[Dict] = []
        self.transitions: List[Dict] = []
        self._next_step = 0
        self.drain_every = max(1, drain_every)
        self._undrained: List[Dict] = []
        self._repair_debt: Dict[int, int] = {}  # domain -> GPUs never failed
        self._ref_snapshot = None
        has_sdc = any(
            isinstance(e.event, SdcSuspectEvent) for e in self.schedule
        )
        if has_sdc and getattr(session, "quarantine", False):
            # arm the quarantine rollback target before any step runs —
            # without a snapshot an SdcSuspectEvent only zeroes the batch
            session.snapshot()
        mesh = getattr(session, "rank_mesh", None)
        # the process that holds the dense reference and checks against it
        self._checks = verify and (mesh is None or mesh.global_rank == 0)
        if verify:
            if session.opt_step != 0:
                raise ValueError("verify=True needs a fresh (step-0) session")
            canonical = session.canonical_params()
        if self._checks:
            self._ref_loss = nt.make_reference_loss(session.cfg)
            self._ref_params = canonical
            self._ref_opt = session.optimizer.init(self._ref_params)
            if has_sdc:
                # the dense reference rolls back to the SAME restore point
                # the session does; the step updates it in place, so keep a
                # host copy of its step-0 state
                self._ref_snapshot = _to_host((self._ref_params,
                                               self._ref_opt))

    # ------------------------------------------------------------- internals

    def _mask(self):
        lb = self.session.local_batches
        full = self.session.local_batch
        return np.concatenate(
            [(np.arange(full) < b).astype(np.float32) for b in lb]
        )

    def _site(self, ev):
        """Debt-ledger key for an event's blast site: the (stage, domain)
        pair on a staged session, the plain domain id otherwise."""
        h = self.session.health
        return (
            h.resolve_site(ev) if hasattr(h, "resolve_site")
            else h.resolve_domain(ev)
        )

    def _check_canonical(self, where: str) -> Optional[float]:
        got = self.session.canonical_params()
        if not self._checks:
            return None
        with torch.no_grad():
            err = float(torch.stack([
                (a - b).abs().max() for a, b in
                zip(tr.leaves(got), tr.leaves(self._ref_params))
            ]).max())
        assert err < self.param_atol, (
            f"{where}: canonical params diverged from dense reference "
            f"(max abs err {err:.3e})"
        )
        return err

    def _apply_due(self, step: int) -> List[LifecycleEvent]:
        applied = []
        tel = telemetry.get()
        while self.schedule and self.schedule[0].step <= step:
            ev = self.schedule.pop(0).event
            kind = event_kind(ev)
            if tel.enabled:
                tel.counter("orchestrator.events", kind=kind)
            with tel.span("orchestrator.event", kind=kind) as sp:
                sp.set(step=step, replica=getattr(ev, "replica", None),
                       domain=getattr(ev, "domain", None),
                       stage=getattr(ev, "stage", None))
                applied += self._apply_one(step, ev, sp)
        return applied

    def _apply_one(self, step: int, ev, sp) -> List[LifecycleEvent]:
        """Consume ONE due event inside its ``orchestrator.event`` span
        (``sp``); returns [ev] if it mutated the session, [] when the event
        was absorbed against repair debt or rejected by the session."""
        old_plan = self.session.plan
        if isinstance(ev, RecoveryEvent):
            # a repair whose failure was rejected must not touch the
            # ledger: its GPU was never marked failed, and applying it
            # would raise TP for hardware that is actually still down
            site = self._site(ev)
            debt = self._repair_debt.get(site, 0)
            if debt:
                absorbed = min(debt, ev.n_gpus)
                self._repair_debt[site] = debt - absorbed
                if absorbed == ev.n_gpus:
                    self.transitions.append({
                        "step": step, "kind": "absorbed", "event": ev,
                        "old_plan": old_plan, "new_plan": old_plan,
                    })
                    sp.set(outcome="absorbed")
                    return []
                if isinstance(site, tuple):
                    ev = RecoveryEvent(step=ev.step, stage=site[0],
                                       domain=site[1],
                                       n_gpus=ev.n_gpus - absorbed)
                else:
                    ev = RecoveryEvent(step=ev.step, domain=site,
                                       n_gpus=ev.n_gpus - absorbed)
        sp.mark("plan")
        try:
            new_plan = self.session.apply(ev)
        except DeadReplicaError as e:
            # the blast would leave a replica with no GPUs — outside
            # NTP's regime (DP_DROP / spares territory, paper §3.3).
            # The session refused before mutating; remember the debt so
            # the GPU's matching repair is absorbed, not applied.
            site = self._site(ev)
            self._repair_debt[site] = (
                self._repair_debt.get(site, 0) + ev.n_gpus
            )
            self.transitions.append({
                "step": step, "kind": "rejected", "event": ev,
                "old_plan": old_plan, "new_plan": old_plan,
                "error": str(e),
            })
            sp.set(outcome="rejected", error=str(e))
            return []
        sp.mark("execute")
        rec = {
            "step": step,
            "kind": event_kind(ev),
            "event": ev,
            "old_plan": old_plan,
            "new_plan": new_plan,
        }
        if getattr(self.session, "last_rollback", False):
            # the session rolled back to its snapshot (SDC quarantine);
            # mirror the same restore point onto the dense reference so the
            # f32 equivalence survives the discarded updates
            rec["rollback"] = True
            sp.set(rollback=True)
            if self.verify:
                if self._checks:
                    self._ref_params, self._ref_opt = _to_device(
                        self._ref_snapshot, self.session.device)
                self._verified(rec, sp, self._check_canonical(
                    f"step {step} (sdc quarantine rollback)"))
        gp = getattr(self.session, "last_global_plan", None)
        if gp is not None:
            # allocator-driven session: keep the global verdict (spare
            # sites, swaps, priced actions) with the transition record
            rec["global_plan"] = gp
        if self.verify and new_plan != old_plan:
            self._verified(rec, sp, self._check_canonical(
                f"step {step} ({rec['kind']} transition {old_plan} -> "
                f"{new_plan})"))
        self.transitions.append(rec)
        sp.set(outcome="applied", old_plan=str(old_plan),
               new_plan=str(new_plan))
        if self.on_event is not None:
            self.on_event(ev, new_plan)
        return [ev]

    @staticmethod
    def _verified(rec, sp, err: Optional[float]) -> None:
        if err is not None:
            rec["canonical_err"] = err
        sp.mark("verified")

    # ------------------------------------------------------------------ run

    def run(self, batch_fn: Callable[[int], object], steps: int) -> List[Dict]:
        """Drive ``steps`` optimizer steps, consuming due events before each.
        ``batch_fn(step)`` must return the full (D·local_batch, S+1) token
        batch (numpy or a tensor). Resumable: repeated calls continue the
        global step counter. Returns the metrics history of THIS call's
        steps."""
        first = self._next_step
        tel = telemetry.get()
        for i in range(first, first + steps):
            applied = self._apply_due(i)
            batch = batch_fn(i)
            metrics = self.session.step(batch)
            rec = {
                "step": i,
                # device scalars on purpose: float() here would make the
                # host wait for every step; _drain() copies them in one go
                "loss": metrics["loss"],
                "grad_norm": metrics["grad_norm"],
                "replica_tp": self.session.plan.replica_tp,
                "local_batches": tuple(int(b) for b in self.session.local_batches),
                "events_applied": len(applied),
            }
            if getattr(self.session.plan, "pp", 1) > 1:
                rec["stage_tp"] = self.session.plan.stage_tp
            if getattr(self.session, "quarantined", ()):
                rec["quarantined"] = self.session.quarantined
            for k in ("power_boost", "rel_iter_time", "stage_rel_iter_time",
                      "policy"):
                if k in metrics:
                    rec[k] = metrics[k]
            self.history.append(rec)
            self._undrained.append(rec)
            if tel.enabled:
                full = self.session.local_batch * self.session.plan.d
                policy = str(rec.get("policy", "none"))
                tel.gauge("train.goodput", sum(rec["local_batches"]) / full,
                          policy=policy)
                base = nt.default_local_batches(
                    self.session.plan, self.session.mode,
                    self.session.local_batch)
                tel.gauge("train.goodput_unboosted",
                          sum(int(b) for b in base) / full, policy=policy)
                # goodput lost to DEGRADATION (straggle/link shed +
                # quarantine) beyond what GPU absence alone implies
                deg_loss = max(
                    0, sum(int(b) for b in base) - sum(rec["local_batches"])
                ) / full
                tel.gauge("train.goodput_degradation_loss", deg_loss,
                          policy=policy)
            if self.verify:
                self._drain()  # the dense-reference compare needs host values
                if self._checks:
                    rl = self._ref_step(batch)
                    diff = abs(rec["loss"] - rl)
                    assert diff < self.atol, (
                        f"step {i}: NTP loss {rec['loss']:.6f} diverged from "
                        f"dense reference {rl:.6f} (|diff| {diff:.3e})"
                    )
                    rec["ref_loss"] = rl
            elif len(self._undrained) >= self.drain_every:
                self._drain()
        self._next_step = first + steps
        self._drain()
        if self.verify:
            self._check_canonical("end of run")
        return self.history[first:]

    def _drain(self) -> None:
        """One host copy of the buffered step metrics, stacked into one
        tensor. History records are mutated in place, so anything already
        handed out (the `run` return value aliases `self.history`) sees
        plain floats."""
        if not self._undrained:
            return
        pending = [(r, k) for r in self._undrained for k in ("loss", "grad_norm")
                   if not isinstance(r[k], float)]
        if pending:
            host = torch.stack([r[k].detach().float().reshape(())
                                for r, k in pending]).tolist()
            for (r, k), v in zip(pending, host):
                r[k] = float(v)
        self._undrained.clear()

    def _ref_step(self, batch) -> float:
        dev = self.session.device
        mask = torch.as_tensor(self._mask(), device=dev)
        tokens = torch.as_tensor(batch, device=dev)
        leaves = tr.tree_map(lambda t: t.detach().requires_grad_(True),
                             self._ref_params)
        rl = self._ref_loss(leaves, tokens, mask)
        flat = torch.autograd.grad(rl, tr.leaves(leaves))
        grads = nt._unflatten_like(leaves, flat)
        del leaves, flat
        self._ref_params, self._ref_opt, _ = self.session.optimizer.update(
            grads, self._ref_opt, self._ref_params
        )
        return float(rl.detach())

    # ------------------------------------------------------------- reporting

    def goodput(self) -> float:
        """Mean fraction of the full minibatch actually trained on — the
        live-session analogue of the paper's lost-throughput metric."""
        if not self.history:
            return 1.0
        full = self.session.local_batch * self.session.plan.d
        return float(np.mean([sum(h["local_batches"]) / full for h in self.history]))

    def summary(self) -> Dict:
        by_kind: Dict[str, int] = {}
        for t in self.transitions:
            by_kind[t["kind"]] = by_kind.get(t["kind"], 0) + 1
        return {
            "steps": len(self.history),
            "failures": by_kind.get("failure", 0),
            "repairs": by_kind.get("repair", 0),
            "rejected": by_kind.get("rejected", 0),
            "absorbed_repairs": by_kind.get("absorbed", 0),
            # the full taxonomy histogram (EVENT_KIND_NAMES vocabulary);
            # binary traces show only failure/repair here
            "events_by_kind": {
                k: v for k, v in by_kind.items()
                if k not in ("rejected", "absorbed")
            },
            "rollbacks": sum(
                1 for t in self.transitions if t.get("rollback")
            ),
            "goodput": self.goodput(),
            "final_plan": self.session.plan,
        }


def _to_host(tree):
    """A host (CPU) copy of a tree of tensors — never a view of it."""
    return tr.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _to_device(tree, device):
    """A fresh copy of a host tree on ``device`` (the host tree stays
    intact for a later rollback)."""
    return tr.tree_map(lambda t: t.to(device, copy=True), tree)
