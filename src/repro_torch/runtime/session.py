"""NTPSession — the runtime entry point for training under failures (port of
`repro/runtime/session.py` for the NTP prototype at pp=1).

Session lifecycle::

    session = NTPSession.create(cfg, (2, 4), local_batch=4,
                                optimizer=optim.adamw(AdamWConfig(lr=1e-2)),
                                power_policy=power_policy("ntp_pw"))
    for i, batch in ...:
        if gpu_died:
            session.apply(FailureEvent(step=i, replica=r))   # replan in place
        if gpu_repaired:
            session.apply(RecoveryEvent(step=i, replica=r))  # TP back up
        metrics = session.step(batch)                        # loss, grad_norm
    session.save("ckpt.npz")                                 # canonical layout

The (data, model) mesh is emulated on one device (`core.ntp_train`).
`apply()` moves params AND optimizer state through the direct packed→packed
transition (`reshard.transition`) on the device: only units whose rank
changes move, fused into one message per (replica, src, dst)
(``session.last_transition`` has the ledger). A `FailureEvent` lowers a
replica's TP, a `RecoveryEvent` raises it back. An optional `PowerPolicy`
(`runtime.orchestrator`) is consulted on every transition to pick each
replica's power boost and usable batch (NTP vs NTP-PW); the step metrics
carry its verdict.

The rest of the health-state taxonomy rides the same `apply()`:
`StragglerEvent`/`LinkDegradeEvent` leave the TP plan alone but reprice the
policy decision through the degradation ledger; `SdcSuspectEvent`
quarantines the replica (batch 0) and, when a `snapshot()` restore point
exists, rolls params and optimizer state back to it (`rollback()`, flagged
in ``session.last_rollback``); each clear/repair unwinds its onset exactly.
`save`/`restore` write and read canonical checkpoints in the reference's
format; a snapshot is the same canonical trees, kept in host memory.

Not ported yet (each raises `NotImplementedError` naming its ROADMAP row):
pp>1 and microbatches, the global allocator (`allocator=`), and the uniform
arch backend (`from_arch`).
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch import telemetry
from repro_torch import tree as tr
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import ntp_train as nt
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.core.ntp_train import Mode, NTPModelConfig
from repro_torch.core.overlap import coerce_overlap
from repro_torch.core.policies import WorkloadGeometry
from repro_torch.kernels import mode as kmode
from repro_torch.optim import AdamWConfig, Optimizer, adamw
from repro_torch.runtime.events import (
    DEGRADATION_EVENTS, ClusterHealth, LifecycleEvent, SdcSuspectEvent,
    event_kind, plan_from_health,
)


def _not_ported(what: str, row: str) -> NotImplementedError:
    return NotImplementedError(
        f"NTPSession: {what} is not ported to repro_torch yet "
        f"(ROADMAP Queue 1: {row})")


class NTPSession:
    """Stateful training session: owns packed params + optimizer state, the
    step for the current FailurePlan, and the health ledger."""

    def __init__(self, *_, **__):
        raise TypeError("use NTPSession.create(...)")

    @classmethod
    def create(
        cls,
        cfg: NTPModelConfig,
        mesh: Sequence[int] = (2, 4),
        *,
        health: Optional[ClusterHealth] = None,
        plan: Optional[FailurePlan] = None,
        mode: Union[Mode, str] = Mode.NTP,
        local_batch: int = 4,
        optimizer: Optional[Optimizer] = None,
        params: Optional[Dict] = None,     # canonical; default random init
        generator: Optional[torch.Generator] = None,
        overlap: bool = False,
        device=None,
        power_policy=None,                 # orchestrator.PowerPolicy
        spares: int = 0,                   # spare domains absorbing failures
        quarantine: bool = True,           # SDC → batch 0 + rollback
        pp: int = 1,
        microbatches: int = 1,
        allocator=None,
    ) -> "NTPSession":
        """NTP-prototype session on an emulated (data=D, model=N1) mesh
        ``mesh``, on ``device`` (CUDA unless ``device="cpu"``). ``health``
        and/or ``plan`` seed the failure state (default: pristine).
        ``params`` are canonical weights (default: drawn from ``generator``
        by `ntp_train.init_canonical`). ``spares`` spare domains absorb the
        worst failures first (`plan_from_health`)."""
        if allocator is not None:
            raise _not_ported("the global repack allocator (allocator=)",
                              "'session spares and allocator'")
        if pp != 1 or microbatches != 1:
            raise _not_ported("pipeline parallelism (pp>1, microbatches)",
                              "'pp>1 in the port'")
        self = object.__new__(cls)
        self._cfg = cfg
        self._device = kmode.resolve_device(device)
        self._mode = Mode.coerce(mode)
        self._local_batch = local_batch
        self._optimizer = optimizer or adamw(AdamWConfig(lr=1e-2))
        if power_policy is not None and self._mode is Mode.DP_DROP:
            raise ValueError(
                "a PowerPolicy decides NTP/NTP-PW batches — contradictory "
                "with Mode.DP_DROP (which zeroes degraded replicas)"
            )
        self._policy = power_policy
        self._spares = spares
        self._overlap = coerce_overlap(overlap)
        self._decision = None
        self._quarantine = quarantine
        self._quarantined = ()
        self._snapshot = None
        self.last_transition = None   # TransferStats of the latest repack
        self.last_rollback = False    # latest apply() rolled back
        d, n1 = (int(x) for x in mesh)
        self._mesh = (d, n1)
        if health is None:
            health = (ClusterHealth.from_plan(plan) if plan is not None
                      else ClusterHealth.pristine(d, n1))
        self._health = health
        packed = plan_from_health(health, spares=spares)
        if plan is not None and plan != packed:
            raise ValueError(
                f"plan {plan} is not in resource-manager packed order "
                f"(most-degraded first); health {health.failed} packs to "
                f"{packed}"
            )
        if (packed.d, packed.n1) != (d, n1):
            raise ValueError(
                f"plan {packed} does not fit mesh (data={d}, model={n1})")
        self._plan = packed
        canonical = params if params is not None else nt.init_canonical(
            cfg, generator, device=self._device)
        self._params = nt.pack_params(cfg, canonical, self._plan)
        self._opt = self._optimizer.init(self._params)
        self._events: List[LifecycleEvent] = []
        self._decide()
        self._build_step()
        return self

    @classmethod
    def from_arch(cls, *_, **__):
        raise _not_ported("the uniform arch-stack backend (from_arch)",
                          "'uniform arch launcher'")

    # ------------------------------------------------------------- introspect

    @property
    def mode(self) -> Mode:
        return self._mode

    @property
    def plan(self) -> FailurePlan:
        return self._plan

    @property
    def health(self) -> ClusterHealth:
        return self._health

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def overlap(self) -> bool:
        """Whether the step runs the overlapped, bucketed gradient sync."""
        return self._overlap

    @property
    def events(self) -> List[LifecycleEvent]:
        return list(self._events)

    @property
    def cfg(self) -> NTPModelConfig:
        return self._cfg

    @property
    def optimizer(self) -> Optimizer:
        return self._optimizer

    @property
    def local_batch(self) -> int:
        return self._local_batch

    @property
    def local_batches(self):
        """Per-replica usable samples under the current plan: the power
        policy's decision, or the mode's default rule; quarantined replicas
        contribute 0."""
        if self._decision is not None:
            return list(self._decision.local_batches)
        lbs = [int(b) for b in nt.default_local_batches(
            self._plan, self._mode, self._local_batch)]
        for r in self._quarantined:
            lbs[r] = 0
        return lbs

    @property
    def quarantine(self) -> bool:
        """Whether SDC suspicions quarantine their replica and roll back to
        the latest `snapshot()`. Off: SDC events are recorded but priced as
        healthy."""
        return self._quarantine

    @property
    def quarantined(self):
        """Replica indices currently quarantined by an open SDC suspicion
        (empty when quarantine is off or no suspicion is open)."""
        return tuple(self._quarantined)

    @property
    def power_decision(self):
        """The PowerPolicy's verdict for the current plan (None: no policy)."""
        return self._decision

    @property
    def params(self):
        """The live packed parameter tree."""
        return self._params

    @property
    def opt_state(self):
        return self._opt

    @property
    def opt_step(self) -> int:
        """The optimizer's step counter (reading it waits for the device)."""
        return int(self._opt["step"])

    @property
    def step_fn(self):
        """The step for the current plan (carries ``.collectives`` and the
        other probes of the step builders)."""
        return self._step_fn

    def canonical_params(self, replica: int = 0) -> Dict:
        """Dense canonical weights recovered from one replica (fresh
        tensors on the session's device)."""
        return nt.unpack_params(self._cfg, self._params, self._plan,
                                replica=replica)

    # ---------------------------------------------------------------- train

    def step(self, batch) -> Dict[str, Any]:
        """One optimizer step on the global (D*local_batch, S+1) token
        array; returns the metrics dict (loss, grad_norm, lr). Values are
        device tensors: reading one waits for the step. Under a PowerPolicy
        the dict also carries its verdict: ``policy``, ``power_boost`` (max
        ×TDP over replicas) and the predicted ``rel_iter_time``.

        With telemetry active the step is a ``session.step`` span; it times
        the host's dispatch of the step (nothing here waits for the
        device)."""
        tel = telemetry.get()
        with tel.span("session.step", backend="ntp", pp=1,
                      overlap="on" if self._overlap else "off"):
            self._params, self._opt, metrics = self._step_fn(
                self._params, self._opt, batch)
        if self._decision is not None:
            if tel.enabled:
                tel.gauge("train.rel_iter_time", self._decision.rel_iter_time,
                          source="analytic", policy=self._decision.method)
                tel.gauge("train.power_boost", self._decision.max_boost,
                          policy=self._decision.method)
            metrics = dict(
                metrics,
                policy=self._decision.method,
                power_boost=self._decision.max_boost,
                rel_iter_time=self._decision.rel_iter_time,
            )
        return metrics

    def measure_sync(self, batch) -> Dict[str, Any]:
        """Measure the step's gradient sync alone: run the step's
        ``grads_fn`` once for a gradients tree, then ``sync_fn`` on it under
        a ``train.sync`` span (phase marks ``issued``/``completed``; attrs
        ``collectives``, ``sync_s`` and ``exposed_s``). On the card the sync
        is timed with CUDA events, on the CPU with the host clock. Measured
        alone the sync is fully exposed (``exposed_s == sync_s``). Returns
        the attrs and ``overlap``."""
        step = self._step_fn
        tel = telemetry.get()
        _, grads = step.grads_fn(self._params, batch)
        label = "on" if step.overlap else "off"
        cuda = self._device.type == "cuda"
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize(self._device)
        with tel.span("train.sync", overlap=label, backend="ntp") as sp:
            sp.mark("issued")
            if cuda:
                start.record()
                step.sync_fn(grads)
                end.record()
                end.synchronize()
                sync_s = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                step.sync_fn(grads)
                sync_s = time.perf_counter() - t0
            sp.mark("completed")
            attrs = {"collectives": int(step.collectives),
                     "sync_s": sync_s, "exposed_s": sync_s}
            sp.set(**attrs)
        return dict(attrs, overlap=label)

    # ---------------------------------------------------------------- events

    def apply(self, event: LifecycleEvent) -> FailurePlan:
        """Consume a health event: update health, replan, and move params
        and optimizer state into the new plan — training continues with the
        same logical weights. A degradation event keeps the TP plan, but
        reprices the policy decision, and an `SdcSuspectEvent` quarantines
        its replica and (with quarantine on and a snapshot taken) rolls
        back. Returns the new plan.

        With telemetry active the whole replan is one ``session.transition``
        span: phase marks ``planned``/``executed`` and, when state moved,
        the executed `TransferStats` ledger as attributes (equal to
        ``last_transition``)."""
        tel = telemetry.get()
        self.last_rollback = False
        with tel.span("session.transition", kind=event_kind(event),
                      pp=1) as sp:
            new_health = self._health.apply(event)
            new_plan = plan_from_health(new_health, spares=self._spares)
            sp.mark("planned")
            self._events.append(event)
            self._health = new_health
            if new_plan == self._plan:
                if isinstance(event, DEGRADATION_EVENTS):
                    # the TP plan is untouched (degradation never removes a
                    # GPU) but the decision moved: batches shrink on
                    # straggle/link, SDC quarantines, boosts re-aim
                    before = tuple(self.local_batches)
                    old_mode = self._mode
                    if self._mode is Mode.UNIFORM and not new_health.healthy:
                        self._mode = Mode.NTP
                    self._decide()
                    if (isinstance(event, SdcSuspectEvent)
                            and self._quarantine
                            and self._snapshot is not None):
                        self.rollback()
                    if (self._mode is not old_mode
                            or tuple(self.local_batches) != before):
                        self._build_step()
                    sp.set(changed=False, degraded=True,
                           rollback=self.last_rollback)
                    return self._plan
                sp.set(changed=False)
                return self._plan

            old_plan = self._plan
            self._transition(old_plan, new_plan)
            sp.mark("executed")
            sp.set(changed=True, old_plan=str(old_plan),
                   new_plan=str(new_plan), **self.last_transition.as_dict())
            if tel.enabled:
                tel.gauge("cluster.transition_bytes",
                          self.last_transition.bytes_moved, source="executed")
            self._plan = new_plan
            if self._mode is Mode.UNIFORM and not new_plan.healthy:
                self._mode = Mode.NTP  # uniform degrades into NTP, not death
            self._decide()
            if (isinstance(event, SdcSuspectEvent) and self._quarantine
                    and self._snapshot is not None):
                self.rollback()
            self._build_step()
            return new_plan

    # ------------------------------------------------------------ checkpoint

    def save(self, path: str) -> None:
        """Write params + optimizer state in CANONICAL layout (the
        reference's npz format): restorable into a session running under
        any FailurePlan, by this package or the reference."""
        save_checkpoint(path, self._canonical_state(), step=self.opt_step)

    def restore(self, path: str) -> int:
        """Load a canonical checkpoint into the CURRENT plan's packing.
        Returns the saved step. Leaves restore at the dtype they were saved
        with (the checkpoint's recorded dtype wins over the live tree's)."""
        spec = tr.tree_map(lambda t: t.to("meta"),
                           {"params": self._params, "opt": self._opt})
        like = {"params": nt.unpack_params(self._cfg, spec["params"],
                                           self._plan),
                "opt": self._canonical_opt(spec["opt"])}
        tree, step = load_checkpoint(path, like, device=self._device)
        self._params = nt.pack_params(self._cfg, tree["params"], self._plan)
        self._opt = self._pack_opt(tree["opt"])
        return step if step is not None else self.opt_step

    def snapshot(self) -> None:
        """Capture a canonical restore point — params AND optimizer state in
        the layout `save` writes, in host memory. `rollback()` repacks it
        into whatever plan is live then, so it survives any number of
        transitions in between (the quarantine rollback target)."""
        self._snapshot = tr.tree_map(
            lambda t: t.detach().to("cpu", copy=True),
            self._canonical_state())

    def rollback(self) -> int:
        """Restore the latest `snapshot()` into the CURRENT plan's packing —
        used when an SDC suspicion quarantines a replica and its recent
        updates are untrusted. Returns the restored optimizer step. `apply()`
        calls this on `SdcSuspectEvent` when quarantine is on and a snapshot
        exists; ``session.last_rollback`` records that it fired."""
        if self._snapshot is None:
            raise RuntimeError(
                "no restore point: call session.snapshot() before relying "
                "on SDC rollback"
            )
        dev = self._device
        params = tr.tree_map(lambda t: t.to(dev), self._snapshot["params"])
        self._params = nt.pack_params(self._cfg, params, self._plan)
        del params
        self._opt = self._pack_opt(tr.tree_map(
            lambda t: t.to(dev, copy=True), self._snapshot["opt"]))
        self.last_rollback = True
        return self.opt_step

    # ---------------------------------------------------------------- private

    def _replica_degradations(self):
        """Per-replica merged degradation ledgers of the current health, or
        None when the health carries none — the binary fail/repair path then
        passes ``degradations=None`` everywhere. SDC entries are masked out
        when quarantine is off, so only straggle/link pricing remains."""
        if self._health.degraded is None:
            return None
        degs = self._health.replica_degradations()
        if not self._quarantine and any(d.sdc for d in degs):
            degs = tuple(replace(d, sdc=0) for d in degs)
        return degs

    def _decide(self) -> None:
        """Consult the PowerPolicy (if any) for the current plan. Geometry is
        derived from the live model: attention quantizes at kv-group (unit)
        granularity. The health's degradation ledgers ride along:
        stragglers/links reprice the slowdown, open SDC suspicions
        quarantine their replica (batch 0)."""
        degs = self._replica_degradations()
        self._quarantined = (
            tuple(r for r, dg in enumerate(degs) if dg.sdc > 0)
            if degs is not None else ()
        )
        if self._policy is None:
            self._decision = None
            return
        geom = self._policy.geom or WorkloadGeometry(
            n_heads=self._cfg.n_kv_groups, local_batch=self._local_batch)
        self._decision = self._policy.decide(
            self._plan, local_batch=self._local_batch, geom=geom,
            degradations=degs,
        )

    def _build_step(self) -> None:
        if self._decision is not None:
            lbs = self._decision.local_batches
        elif self._quarantined:
            lbs = tuple(self.local_batches)
        else:
            lbs = None  # the builder's default rule — binary path unchanged
        self._step_fn = nt.make_ntp_train_step(
            self._cfg, self._plan, self._mesh, mode=self._mode,
            local_batch=self._local_batch, optimizer=self._optimizer,
            local_batches=lbs, overlap=self._overlap,
        )

    def _transition(self, old: FailurePlan, new: FailurePlan) -> None:
        """One fused packed→packed transition for params AND every
        param-like optimizer tree (AdamW m/v/master): all ride the same
        per-(replica, src, dst) messages. The ledger is kept in
        `last_transition`."""
        from repro_torch.reshard.transition import transition_trees

        opt_keys = [k for k in self._optimizer.param_like if k in self._opt]
        trees = [self._params] + [self._opt[k] for k in opt_keys]
        moved, stats = transition_trees(self._cfg, trees, old, new)
        self._params = moved[0]
        self._opt = dict(self._opt, **dict(zip(opt_keys, moved[1:])))
        self.last_transition = stats

    def _canonical_state(self) -> Dict:
        """{"params", "opt"} in canonical layout: fresh tensors for every
        param-like tree, the optimizer's other leaves (its step) as held."""
        return {"params": self.canonical_params(),
                "opt": self._canonical_opt(self._opt)}

    def _canonical_opt(self, opt: Dict) -> Dict:
        return {
            k: (nt.unpack_params(self._cfg, v, self._plan)
                if k in self._optimizer.param_like else v)
            for k, v in opt.items()
        }

    def _pack_opt(self, canonical_opt: Dict) -> Dict:
        return {
            k: (nt.pack_params(self._cfg, v, self._plan)
                if k in self._optimizer.param_like else v)
            for k, v in canonical_opt.items()
        }
