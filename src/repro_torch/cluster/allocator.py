"""The global repack planner (port of `repro/cluster/allocator.py`): a
greedy search over the joint assignment space of a `StagedHealth` ledger
that stage-local packing cannot reach.

Stage-local packing (`staged_plan_from_health`) already aligns each stage's
worst failures onto the lowest replicas; the allocator's wins are the moves
that cross stages:

* **cluster-wide spares**: a spare domain stands in for the worst failure
  site across all stages (per-stage packing cannot express this);
* **cross-stage swaps**: at skewed failure distributions, exchanging a
  badly failed domain in one stage with a healthy domain of another
  concentrates failures onto fewer replicas (1F1B gates each replica at its
  slowest stage, so two half-wounded replicas are worse than one wounded
  and one healthy);
* **adaptive reordering**: each stage's pack permutation follows the moved
  counts; the allocator emits it with the per-stage transition actions.

Every candidate move is priced by the `TransitionCostModel` (the same
per-replica transition plans the reshard engine executes) and gated by
amortization: accepted only when the predicted goodput gain over
``horizon_steps`` recovers the transfer time. Rescue moves (revivals of a
replica some stage has at TP 0) bypass the gate. With nothing to gain the
allocator returns the stage-local packing unchanged.

The port keeps the reference's search move for move, ties included, so its
verdicts equal the reference's on the same ledger: a swap may refill a site
a spare zeroed earlier in the same search, as the reference's does (its
conservation property fails on ``n1=2, counts ((0,1,1),(2,0,0)),
spares=1``; ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import telemetry
from repro_torch.cluster.actions import Action
from repro_torch.cluster.cost import TransitionCostModel
from repro_torch.cluster.goodput import GoodputModel
from repro_torch.cluster.plan import GlobalPlan
from repro_torch.core.nonuniform import StagedPlan


@dataclass(frozen=True)
class AllocatorConfig:
    """Search knobs. ``horizon_steps`` is the amortization window: a move
    must recover its transfer time within this many steps of predicted
    goodput gain. ``horizon_steps=0`` disables every priced move — the
    allocator then reproduces stage-local packing bit-exactly (the
    hypothesis suite's equivalence property)."""

    horizon_steps: int = 200
    min_gain: float = 1e-9          # goodput delta below this is noise
    max_rounds: Optional[int] = None  # None: spares + pp^2 + 8


class GreedyAllocator:
    """Greedy best-move-first search; deterministic (ties break toward the
    cheaper move, then the lower (stage, domain) site — so an idle spare
    stays pinned to its site across events instead of churning).

    ``goodput`` and ``cost`` are bound by the owner (`NTPSession.create`
    calibrates the cost model from its live trees); an unbound cost model
    prices every move at zero bytes (pure goodput mode — fine for planning
    games, wrong for a live session)."""

    name = "greedy"

    def __init__(self, config: Optional[AllocatorConfig] = None, *,
                 goodput: Optional[GoodputModel] = None,
                 cost: Optional[TransitionCostModel] = None):
        self.config = config or AllocatorConfig()
        self.goodput = goodput
        self.cost = cost
        self.last_plan: Optional[GlobalPlan] = None

    def bind(self, *, goodput: Optional[GoodputModel] = None,
             cost: Optional[TransitionCostModel] = None) -> "GreedyAllocator":
        if goodput is not None:
            self.goodput = goodput
        if cost is not None:
            self.cost = cost
        return self

    # ---------------------------------------------------------------- search

    def plan(self, health, *, spares: int = 0,
             current: Optional[StagedPlan] = None) -> GlobalPlan:
        """Allocate for one `StagedHealth` ledger. ``current`` is the plan
        whose state is in place (None = fresh packing: transitions are
        free). Raises `DeadReplicaError` (via per-stage packing) if even the
        allocated layout leaves a replica at TP 0 in some stage."""
        with telemetry.get().span("cluster.plan", spares=spares) as sp:
            return self._plan_spanned(health, spares, current, sp)

    def _plan_spanned(self, health, spares, current, sp) -> GlobalPlan:
        from repro_torch.runtime.events import StagedHealth

        assert isinstance(health, StagedHealth), type(health)
        assert all(h.domains_per_replica == 1 for h in health.stages), (
            "the global allocator plans one-domain-per-stage replicas "
            "(the staged runtime's geometry)")
        n1, pp = health.domain_size, health.pp
        gm = self.goodput if self.goodput is not None else GoodputModel(n1=n1)
        assert gm.n1 == n1, (gm.n1, n1)
        cfgc = self.config
        horizon = cfgc.horizon_steps

        counts0 = [np.asarray(h.failed, dtype=int).copy()
                   for h in health.stages]
        # degradation ledgers ride along with their PHYSICAL domain: a swap
        # moves a site's straggle/link/sdc state together with its failed
        # count, and a spare stand-in clears both (the spare is pristine)
        degs0 = None
        if any(h.degraded is not None for h in health.stages):
            degs0 = [list(h.degraded) if h.degraded is not None
                     else [None] * len(h.failed) for h in health.stages]
        base_goodput = gm.goodput(counts0, degs0)
        baseline = self._try_pack(counts0, n1)

        work = [c.copy() for c in counts0]
        work_degs = (None if degs0 is None
                     else [list(d) for d in degs0])
        g_cur = gm.goodput(work, work_degs)
        price_cur = self._price_bytes(current, work, n1)
        pool = spares
        spare_sites: List[Tuple[int, int, int]] = []
        swaps: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
        actions: List[Action] = []

        max_rounds = cfgc.max_rounds
        if max_rounds is None:
            max_rounds = spares + pp * pp + 8
        considered = 0
        for _ in range(max_rounds):
            best = None
            n_dead = int((gm.effective_tp(work) <= 0).sum())
            for cand in self._candidates(work, pool, work_degs):
                considered += 1
                w2, deg2 = self._apply_move(work, cand, work_degs)
                g2 = gm.goodput(w2, deg2)
                dg = g2 - g_cur
                dead_fixed = n_dead - int((gm.effective_tp(w2) <= 0).sum())
                price2 = self._price_bytes(current, w2, n1)
                # a zero-gain move is still worth taking when it SHAVES the
                # predicted transition (e.g. relocating an idle spare so one
                # fewer stage repacks) — traffic saved at no goodput cost
                saves = price2 < price_cur and dg >= -cfgc.min_gain
                if dg <= cfgc.min_gain and dead_fixed <= 0 and not saves:
                    continue
                marg = max(0, price2 - price_cur)
                cost_s = (self.cost.seconds(marg)
                          if self.cost is not None else 0.0)
                gain_s = gm.gain_seconds(max(dg, 0.0), horizon)
                rescue = dead_fixed > 0
                if not rescue and cost_s > gain_s:
                    continue  # does not amortize within the horizon
                # rank: revive first, then net benefit; ties to the cheaper
                # final transition, then the lower site (deterministic +
                # anti-churn)
                key = (dead_fixed, gain_s - cost_s, dg, -price2,
                       cand[0] == "spare",
                       tuple(-x for x in cand[1]),
                       tuple(-x for x in (cand[2] or (0, 0))))
                if best is None or key > best[0]:
                    best = (key, cand, w2, deg2, g2, price2, marg, cost_s,
                            gain_s, rescue)
            if best is None:
                break
            (_, cand, w2, deg2, g2, price2, marg, cost_s, gain_s,
             rescue) = best
            kind, site, other = cand
            if kind == "spare":
                absorbed = int(work[site[0]][site[1]])
                pool -= 1
                spare_sites.append((site[0], site[1], absorbed))
                actions.append(Action(
                    "spare", gain_s=gain_s, cost_s=cost_s, bytes=marg,
                    rescue=rescue, site=site, absorbed=absorbed,
                    note=f"spare domain stands in for stage {site[0]} "
                         f"domain {site[1]} ({absorbed} failed)"))
            else:
                swaps.append((site, other))
                actions.append(Action(
                    "swap", gain_s=gain_s, cost_s=cost_s, bytes=marg,
                    rescue=rescue, site=site, other=other,
                    note=f"swap stage {site[0]} domain {site[1]} with "
                         f"stage {other[0]} domain {other[1]}"))
            work, work_degs, g_cur, price_cur = w2, deg2, g2, price2

        final = self._pack(work, n1)   # DeadReplicaError if still dead
        actions.extend(self._transition_actions(current, final, work))
        predicted = self._price_bytes(current, work, n1)
        gp = GlobalPlan(
            staged_plan=final,
            actions=tuple(actions),
            counts=tuple(tuple(int(x) for x in c) for c in work),
            spare_sites=tuple(spare_sites),
            swaps=tuple(swaps),
            goodput=g_cur,
            baseline_goodput=base_goodput,
            baseline=baseline,
            predicted_bytes=predicted,
            horizon_steps=horizon,
        )
        sp.set(moves_considered=considered,
               moves_taken=len(spare_sites) + len(swaps),
               predicted_bytes=predicted,
               goodput=round(g_cur, 6))
        tel = telemetry.get()
        if tel.enabled:
            # paired series with the session's source="executed" gauge:
            # predicted-vs-executed transition traffic on one track
            tel.gauge("cluster.transition_bytes", predicted,
                      source="predicted")
        self.last_plan = gp
        return gp

    # ------------------------------------------------------------ internals

    @staticmethod
    def _candidates(work, pool, degs=None):
        """Deterministic candidate moves for one round: every failed OR
        degraded site as a spare target (pool permitting), for each ordered
        stage pair the worst site of one against the best site of the other,
        and each degraded site against the most/least-failed site of every
        other stage (pairing a straggler with an already-slow replica or
        isolating it — `GoodputModel.goodput` decides which pays)."""
        pp = len(work)

        def degraded(s, d):
            return (degs is not None and degs[s][d] is not None
                    and not degs[s][d].clear)

        if pool > 0:
            for s in range(pp):
                for dom in range(len(work[s])):
                    if work[s][dom] > 0 or degraded(s, dom):
                        yield ("spare", (s, dom), None)
        for s1 in range(pp):
            if not work[s1].any():
                continue
            i = int(np.argmax(work[s1]))
            for s2 in range(pp):
                if s2 == s1:
                    continue
                j = int(np.argmin(work[s2]))
                if work[s1][i] > work[s2][j]:
                    yield ("swap", (s1, i), (s2, j))
        if degs is None:
            return
        for s1 in range(pp):
            for dom in range(len(work[s1])):
                if not degraded(s1, dom):
                    continue
                for s2 in range(pp):
                    if s2 == s1:
                        continue
                    for j in (int(np.argmax(work[s2])),
                              int(np.argmin(work[s2]))):
                        yield ("swap", (s1, dom), (s2, j))

    @staticmethod
    def _apply_move(work, cand, degs=None):
        kind, site, other = cand
        w2 = [c.copy() for c in work]
        d2 = None if degs is None else [list(d) for d in degs]
        if kind == "spare":
            w2[site[0]][site[1]] = 0
            if d2 is not None:
                d2[site[0]][site[1]] = None   # the stand-in is pristine
        else:
            a, b = w2[site[0]][site[1]], w2[other[0]][other[1]]
            w2[site[0]][site[1]], w2[other[0]][other[1]] = b, a
            if d2 is not None:
                da, db = d2[site[0]][site[1]], d2[other[0]][other[1]]
                d2[site[0]][site[1]], d2[other[0]][other[1]] = db, da
        return w2, d2

    @staticmethod
    def _pack(work, n1) -> StagedPlan:
        from repro_torch.runtime.events import ClusterHealth, plan_from_health

        return StagedPlan(tuple(
            plan_from_health(ClusterHealth(n1, tuple(int(x) for x in c)))
            for c in work
        ))

    @classmethod
    def _try_pack(cls, work, n1) -> Optional[StagedPlan]:
        from repro_torch.runtime.events import DeadReplicaError

        try:
            return cls._pack(work, n1)
        except DeadReplicaError:
            return None

    def _price_bytes(self, current: Optional[StagedPlan], work, n1) -> int:
        """Predicted traffic of the ONE transition current→pack(work). A
        layout that cannot pack (dead) prices at 0 — it is gated by goodput
        (0 for dead replicas), never executed."""
        if self.cost is None or current is None:
            return 0
        cand = self._try_pack(work, n1)
        if cand is None:
            return 0
        return self.cost.predict_bytes(current, cand)

    def _transition_actions(self, current: Optional[StagedPlan],
                            final: StagedPlan, work) -> List[Action]:
        """Ordered per-stage state movements executing ``final`` against
        ``current``, each with its predicted traffic and the stage's new
        pack permutation (the adaptive reordering)."""
        if current is None:
            return []
        from repro_torch.configs.shapes import stage_boundaries

        acts: List[Action] = []
        n_layers = self.cost.n_layers if self.cost is not None else final.pp
        bounds = stage_boundaries(n_layers, final.pp)
        for s in range(final.pp):
            if final.stages[s] == current.stages[s]:
                continue
            nbytes = 0
            if self.cost is not None:
                nbytes = self.cost.stage_bytes_for(
                    current.stages[s], final.stages[s],
                    bounds[s + 1] - bounds[s])
            order = tuple(int(x) for x in np.argsort(-work[s], kind="stable"))
            acts.append(Action(
                "transition", stage=s, bytes=nbytes,
                cost_s=(self.cost.seconds(nbytes)
                        if self.cost is not None else 0.0),
                order=order,
                note=f"repack stage {s}: {current.stages[s].replica_tp} -> "
                     f"{final.stages[s].replica_tp}"))
        return acts


def make_allocator(name: Optional[str], **kwargs) -> Optional[GreedyAllocator]:
    """CLI/config factory: ``"greedy"`` → a fresh `GreedyAllocator` (kwargs
    feed `AllocatorConfig`), ``"off"``/``None`` → None (stage-local
    packing)."""
    if name in (None, "off", "none"):
        return None
    if name == "greedy":
        return GreedyAllocator(AllocatorConfig(**kwargs))
    raise ValueError(f"unknown allocator {name!r} (choose: greedy, off)")
