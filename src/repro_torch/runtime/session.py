"""NTPSession — the runtime entry point for training under failures (port of
`repro/runtime/session.py` for the NTP prototype).

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

``pp > 1`` partitions the layers into contiguous pipeline stages: health
is kept per (replica, stage) (`StagedHealth`), an event lands on one stage,
and only that stage's layers move (`transition_staged_trees`; the other
stages pass through untouched). Each stage syncs its gradients under its
own plan, the local batches follow the slowest stage, and the step metrics
carry each stage's predicted relative iteration time
(``stage_rel_iter_time``; ``rel_iter_time`` is their max). ``microbatches``
splits the local batch into 1F1B chunks.

The rest of the health-state taxonomy rides the same `apply()`:
`StragglerEvent`/`LinkDegradeEvent` leave the TP plan alone but reprice the
policy decision through the degradation ledger; `SdcSuspectEvent`
quarantines the replica (batch 0) and, when a `snapshot()` restore point
exists, rolls params and optimizer state back to it (`rollback()`, flagged
in ``session.last_rollback``); each clear/repair unwinds its onset exactly.
`save`/`restore` write and read canonical checkpoints in the reference's
format; a snapshot is the same canonical trees, kept in host memory.

On a `launch.mesh.RankMesh` (``mesh=make_test_mesh(...)`` in each process
of a `launch.spawn` run) the session is one (replica, rank) process of the
job: it holds its own packed slots, steps with `make_rank_train_step` (or,
with ``overlap``, `core.overlap.make_overlapped_rank_train_step`), moves
its slots with `transition_rank_trees` and gathers canonical weights over
its replica's model group. Every process applies the same events in the
same order (the health ledger, the power policy and the spares are host
decisions on the replicated ledger), and a failed rank stays in its groups
holding pad slots, as on the reference's fixed mesh. Snapshots are per
rank (each keeps a host copy of its own slots and their plan; a rollback
under another plan runs `transition_rank_trees`), checkpoints canonical.
``pp > 1`` there takes the reference's route by the mesh: on a 2-D
`RankMesh` every process holds every layer and steps stage-sequentially;
on a staged mesh (`launch.mesh.make_staged_mesh`, validated by
`core.pp_submesh.validate_staged_mesh`) each process holds its stage's
share, steps through the rank pipeline (`core.pp_submesh`) and an event
moves only the processes of the stage it hits. The step metrics of the
pipeline carry ``pipeline_ticks`` and the ``handoff`` byte table, as the
reference's.

``allocator`` (a `repro_torch.cluster.GreedyAllocator`) turns every pp>1
replan into the global search (spares assignable to any stage, cost-priced
cross-stage swaps), and is what makes ``spares > 0`` legal at pp>1. The
session binds the allocator's goodput model to its own geometry and its
cost model to the live packed trees, so the verdict's predicted bytes equal
the executed ledger; the latest verdict is ``session.last_global_plan``.
On a process-group run every process plans on its replicated ledger, and
the cost model is calibrated from the process's own slots
(`TransitionCostModel.from_rank_trees`), checked equal on every process.

`NTPSession.from_arch` is the second backend, as in the reference: a
uniform session over the production arch stack (`train.steps.make_setup`'s
train step on one device), backend ``"arch"``, `Mode.UNIFORM`, whose
`step()` returns the step's metrics. A failure there is a full restart:
the lifecycle calls (`apply`, `save`/`restore`, `snapshot`/`rollback`,
`measure_sync`, canonical weights and local-batch accounting) raise
`NotImplementedError` naming the NTP backend, with the reference's
wording.
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
from repro_torch.configs.shapes import stage_boundaries
from repro_torch.core.nonuniform import FailurePlan, StagedPlan, as_staged
from repro_torch.core.ntp_train import Mode, NTPModelConfig
from repro_torch.core.overlap import coerce_overlap
from repro_torch.core.policies import WorkloadGeometry, staged_rel_iter_times
from repro_torch.core.power import PowerModel
from repro_torch.kernels import mode as kmode
from repro_torch.launch.mesh import RankMesh
from repro_torch.optim import AdamWConfig, Optimizer, adamw
from repro_torch.runtime.events import (
    DEGRADATION_EVENTS, ClusterHealth, LifecycleEvent, SdcSuspectEvent,
    StagedHealth, event_kind,
    plan_from_health, staged_plan_from_health,
)


class NTPSession:
    """Stateful training session: owns packed params + optimizer state, the
    step for the current FailurePlan, and the health ledger."""

    def __init__(self, *_, **__):
        raise TypeError(
            "use NTPSession.create(...) or NTPSession.from_arch(...)")

    @classmethod
    def create(
        cls,
        cfg: NTPModelConfig,
        mesh: Union[Sequence[int], RankMesh] = (2, 4),
        *,
        health: Optional[Union[ClusterHealth, StagedHealth]] = None,
        plan: Optional[Union[FailurePlan, StagedPlan]] = None,
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
        pp: int = 1,                       # pipeline stages
        microbatches: int = 1,             # 1F1B chunks per step
        allocator=None,                    # cluster.GreedyAllocator (pp > 1)
    ) -> "NTPSession":
        """NTP-prototype session on an emulated (data=D, model=N1) mesh
        ``mesh``, on ``device`` (CUDA unless ``device="cpu"``). ``health``
        and/or ``plan`` seed the failure state (default: pristine).
        ``params`` are canonical weights (default: drawn from ``generator``
        by `ntp_train.init_canonical`). ``spares`` spare domains absorb the
        worst failures first (`plan_from_health`; pp=1 only).

        ``pp > 1`` partitions the transformer into contiguous layer stages
        (`configs.shapes.stage_boundaries`); health is then kept per
        (replica, stage) and a failure reduces TP only for the stage whose
        scale-up domain lost the GPU. Seed it with a `StagedHealth` or a
        `StagedPlan` (a plain one is refused: it does not say which stage
        is hit); a pp=1 staged seed is unwrapped, so ``pp=1`` is the
        unstaged session.

        ``mesh`` may be this process's `RankMesh` (a process-group run): the
        session is then its (replica, rank) part, on the mesh's device.

        ``allocator`` (a `repro_torch.cluster.GreedyAllocator`, pp > 1 only)
        makes every replan the global search, which takes ``spares`` at
        pp > 1; its latest verdict is ``session.last_global_plan``."""
        if allocator is not None and pp <= 1:
            raise ValueError(
                "allocator= is the pp>1 global repack planner; pp=1 sessions "
                "already pack globally (plan_from_health handles spares)"
            )
        rank_mesh = mesh if isinstance(mesh, RankMesh) else None
        self = object.__new__(cls if rank_mesh is None else _RankSession)
        self._cfg = cfg
        self._rank_mesh = rank_mesh
        self._device = rank_mesh.device if rank_mesh is not None else \
            kmode.resolve_device(device)
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
        self._stage_rel = None
        self._quarantine = quarantine
        self._quarantined = ()
        self._snapshot = None
        self.last_transition = None   # TransferStats of the latest repack
        self.last_rollback = False    # latest apply() rolled back
        self.last_global_plan = None  # the allocator's latest GlobalPlan
        d, n1 = (int(x) for x in mesh)
        self._mesh = (d, n1)
        self._allocator = allocator
        if allocator is not None:
            from repro_torch.cluster import GoodputModel

            method = ("ntp_pw" if power_policy is not None
                      and power_policy.name == "ntp_pw" else "ntp")
            allocator.bind(goodput=GoodputModel(
                n1=n1,
                geom=WorkloadGeometry(n_heads=cfg.n_kv_groups,
                                      local_batch=local_batch),
                method=method,
                power=(power_policy.model if power_policy is not None
                       else PowerModel()),
            ))

        if pp < 1:
            raise ValueError(f"pp must be >= 1, got {pp}")
        if isinstance(plan, StagedPlan) and plan.pp == 1:
            plan = plan.stages[0]
        if isinstance(health, StagedHealth) and health.pp == 1:
            health = health.stages[0]
        for given, what in ((plan, "plan"), (health, "health")):
            given_pp = getattr(given, "pp", None)
            if given_pp is not None and pp != 1 and given_pp != pp:
                raise ValueError(
                    f"{what} has {given_pp} stages but pp={pp} was requested"
                )
            if given_pp is not None:
                pp = given_pp
            elif given is not None and pp != 1:
                # a plain FailurePlan/ClusterHealth is ambiguous under pp>1
                # (per-stage state differs by stage); broadcasting failures
                # to every stage would silently change their blast radius
                raise ValueError(
                    f"pp={pp} needs a staged {what} "
                    f"(StagedPlan/StagedHealth), got {type(given).__name__}"
                )
        if getattr(mesh, "pp", 1) > 1:
            # a pipeline of processes: one mesh stage per pipeline stage,
            # checked before any compute
            from repro_torch.core.pp_submesh import validate_staged_mesh

            validate_staged_mesh(mesh, pp)
        self._pp = pp
        self._microbatches = microbatches
        self._boundaries = stage_boundaries(cfg.n_layers, pp)
        if pp == 1:
            if health is None:
                health = (ClusterHealth.from_plan(plan) if plan is not None
                          else ClusterHealth.pristine(d, n1))
            packed = plan_from_health(health, spares=spares)
            if plan is not None and plan != packed:
                raise ValueError(
                    f"plan {plan} is not in resource-manager packed order "
                    f"(most-degraded first); health {health.failed} packs to "
                    f"{packed}"
                )
        else:
            if health is None:
                health = (StagedHealth.from_plan(as_staged(plan))
                          if plan is not None
                          else StagedHealth.pristine(d, n1, pp))
            packed = self._staged_replan(health, current=None)
            if plan is not None and as_staged(plan) != packed:
                raise ValueError(
                    f"staged plan {plan} is not in per-stage packed order "
                    f"(most-degraded first per stage); health packs to "
                    f"{packed}"
                )
        self._health = health
        if (packed.d, packed.n1) != (d, n1):
            raise ValueError(
                f"plan {packed} does not fit mesh (data={d}, model={n1})")
        self._plan = packed
        canonical = params if params is not None else nt.init_canonical(
            cfg, generator, device=self._device, pp=pp,
            stage=nt._rank_stage(rank_mesh))
        self._params = self._pack(canonical)
        self._opt = self._optimizer.init(self._params)
        if allocator is not None:
            # price moves from the live trees (params + every param-like
            # optimizer tree ride the same messages): predicted bytes then
            # equal the executed ledger
            allocator.bind(cost=self._cost_model(self._param_trees()[1]))
        self._events: List[LifecycleEvent] = []
        self._decide()
        self._build_step()
        return self

    @classmethod
    def from_arch(
        cls,
        cfg,                    # repro_torch.configs.base.ArchConfig
        shape,                  # repro_torch.configs.shapes.ShapeSpec (train)
        mesh=None,
        *,
        opt_cfg: Optional[AdamWConfig] = None,
        param_dtype=torch.float32,
        lr_schedule=None,
        generator: Optional[torch.Generator] = None,
        params: Optional[Dict] = None,
        device=None,
        microbatches: int = 1,
    ) -> "NTPSession":
        """Uniform session over the production arch stack
        (`train.steps.make_setup`) on ``device`` (CUDA unless
        ``device="cpu"``). ``params`` are the model's parameters in the
        port's layout (tensors or numpy arrays, e.g.
        `convert.params_from_jax` of the reference's `init`), copied, each
        leaf keeping its dtype; by default they are drawn from
        ``generator`` (seed 0). The AdamW state starts from `adamw_init`;
        ``microbatches`` > 1 accumulates the gradients of that many equal
        chunks of each batch. ``mesh``: this process's
        `launch.mesh.RankMesh` (sharded execution of the dense attention
        archs, `make_setup` on the mesh): the given params are placed,
        each process keeping its shards, or each process draws the same
        seed leaf by leaf, keeping its shards (`Setup.init_params`); the
        AdamW state is ZeRO-1's."""
        from repro_torch.train.steps import make_setup

        kw = {} if lr_schedule is None else {"lr_schedule": lr_schedule}
        setup = make_setup(cfg, shape, mesh, param_dtype=param_dtype,
                           opt_cfg=opt_cfg, microbatches=microbatches,
                           device=device, **kw)
        self = object.__new__(_ArchSession)
        self._setup = setup
        self._step_fn = setup.step_fn
        self._cfg = cfg
        self._mesh = mesh
        self._device = setup.model.device
        self._mode = Mode.UNIFORM
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self._device).manual_seed(0)
            self._params = setup.init_params(generator)
        else:
            self._params = setup.place(params)
        self._opt = setup.init_opt_state(self._params)
        self._health = self._plan = None
        self._rank_mesh = mesh
        self._events = []
        self._policy = self._decision = self._stage_rel = None
        self._spares = 0
        self._overlap = False
        self._pp = 1
        self._boundaries = (0, cfg.n_layers)
        self._microbatches = microbatches
        self._allocator = None
        self._quarantine = False
        self._quarantined = ()
        self._snapshot = None
        self.last_transition = None
        self.last_global_plan = None
        self.last_rollback = False
        return self

    # ------------------------------------------------------------- introspect

    @property
    def backend(self) -> str:
        """``"ntp"`` (`create`, the full lifecycle surface) or ``"arch"``
        (`from_arch`, uniform training only — lifecycle calls raise
        `NotImplementedError` naming the alternative)."""
        return "ntp"

    @property
    def mode(self) -> Mode:
        return self._mode

    @property
    def plan(self) -> Union[FailurePlan, StagedPlan]:
        """The live plan: a `FailurePlan` for pp=1, a `StagedPlan` for
        pp > 1."""
        return self._plan

    @property
    def health(self) -> Union[ClusterHealth, StagedHealth]:
        return self._health

    @property
    def pp(self) -> int:
        return self._pp

    @property
    def stage_boundaries(self):
        """Layer boundaries of the pipeline stages (pp+1 ints)."""
        return self._boundaries

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def rank_mesh(self) -> Optional[RankMesh]:
        """This process's `RankMesh` on a process-group run, else None (the
        emulated mesh)."""
        return self._rank_mesh

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
        ×TDP over replicas) and the predicted ``rel_iter_time``; a staged
        session adds ``stage_rel_iter_time`` (one per stage) and sets
        ``rel_iter_time`` to its max.

        With telemetry active the step is a ``session.step`` span; it times
        the host's dispatch of the step (nothing here waits for the
        device)."""
        tel = telemetry.get()
        with tel.span("session.step", backend="ntp", pp=self._pp,
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
        if self._stage_rel is not None:
            # a staged session always predicts per-stage relative iteration
            # time (the slowest stage gates the replica), policy or not
            metrics = dict(metrics, stage_rel_iter_time=self._stage_rel,
                           rel_iter_time=max(self._stage_rel))
        if getattr(self._step_fn, "submesh", False):
            # the pipeline of processes annotates its schedule: the ticks
            # behind the bubble and the step's hand-off byte table
            metrics = dict(metrics, pipeline_ticks=self._step_fn.ticks,
                           handoff=self._step_fn.handoff)
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

    def apply(self, event: LifecycleEvent):
        """Consume a health event: update health, replan, and move params
        and optimizer state into the new plan — training continues with the
        same logical weights. A degradation event keeps the TP plan, but
        reprices the policy decision, and an `SdcSuspectEvent` quarantines
        its replica and (with quarantine on and a snapshot taken) rolls
        back. On a staged session the event resolves to ONE pipeline stage
        (`StagedHealth.resolve_site`) and only that stage's layers move.
        Returns the new plan (`FailurePlan` for pp=1, `StagedPlan` else).

        With telemetry active the whole replan is one ``session.transition``
        span: phase marks ``planned``/``executed`` and, when state moved,
        the executed `TransferStats` ledger as attributes (equal to
        ``last_transition``)."""
        tel = telemetry.get()
        self.last_rollback = False
        with tel.span("session.transition", kind=event_kind(event),
                      pp=self._pp) as sp:
            new_health = self._health.apply(event)
            if self._pp == 1:
                new_plan = plan_from_health(new_health, spares=self._spares)
            else:
                new_plan = self._staged_replan(new_health, current=self._plan)
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
            if self._pp == 1:
                self._transition(old_plan, new_plan)
            else:
                self._transition_staged(old_plan, new_plan)
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

    def _staged_replan(self, health: StagedHealth, *, current):
        """One pp>1 replan: the global allocator when bound (moves priced
        against ``current``'s in-place state, the verdict kept in
        ``last_global_plan``), stage-local packing otherwise."""
        if self._allocator is not None:
            gp = self._allocator.plan(health, spares=self._spares,
                                      current=current)
            self.last_global_plan = gp
            return gp.staged_plan
        return staged_plan_from_health(health, spares=self._spares)

    def _cost_model(self, trees):
        """The allocator's `TransitionCostModel`, calibrated from ``trees``
        (the emulated (D, n1·buf, *unit) unit leaves)."""
        from repro_torch.cluster import TransitionCostModel

        return TransitionCostModel.from_trees(self._cfg, trees, pp=self._pp)

    def _replica_degradations(self):
        """Per-replica merged degradation ledgers of the current health, or
        None when the health carries none — the binary fail/repair path then
        passes ``degradations=None`` everywhere. SDC entries are masked out
        when quarantine is off, so only straggle/link pricing remains."""
        h = self._health
        if isinstance(h, StagedHealth):
            if all(st.degraded is None for st in h.stages):
                return None
        elif h.degraded is None:
            return None
        degs = h.replica_degradations()
        if not self._quarantine and any(d.sdc for d in degs):
            degs = tuple(replace(d, sdc=0) for d in degs)
        return degs

    def _decide(self) -> None:
        """Consult the PowerPolicy (if any) for the current plan. Geometry is
        derived from the live model: attention quantizes at kv-group (unit)
        granularity. A staged plan decides on its `effective` (slowest-stage)
        reduction and also predicts each stage's relative iteration time for
        the step metrics. The health's degradation ledgers ride along:
        stragglers/links reprice the slowdown, open SDC suspicions
        quarantine their replica (batch 0)."""
        self._stage_rel = None
        degs = self._replica_degradations()
        self._quarantined = (
            tuple(r for r, dg in enumerate(degs) if dg.sdc > 0)
            if degs is not None else ()
        )
        eff_plan = self._plan.effective if self._pp > 1 else self._plan
        geom = (self._policy.geom if self._policy is not None else None) or \
            WorkloadGeometry(n_heads=self._cfg.n_kv_groups,
                             local_batch=self._local_batch)
        if self._policy is None:
            self._decision = None
        else:
            self._decision = self._policy.decide(
                eff_plan, local_batch=self._local_batch, geom=geom,
                degradations=degs,
            )
        if self._pp > 1:
            if self._decision is not None:
                boosts = self._decision.boost
                lbs = self._decision.local_batches
                power = self._policy.model
            else:
                boosts = None
                lbs = [int(b) for b in nt.default_local_batches(
                    eff_plan, self._mode, self._local_batch)]
                for r in self._quarantined:
                    lbs[r] = 0
                lbs = tuple(lbs)
                power = PowerModel()
            if degs is not None:
                slow_factors = tuple(dg.slow_factor for dg in degs)
                bw_fracs = tuple(dg.bw_frac for dg in degs)
            else:
                slow_factors = bw_fracs = None
            self._stage_rel = staged_rel_iter_times(
                self._plan.stage_tp, self._plan.n1, geom,
                local_batches=lbs, local_batch=self._local_batch,
                boosts=boosts, power=power,
                slow_factors=slow_factors, bw_fracs=bw_fracs,
            )

    def _build_step(self) -> None:
        if self._decision is not None:
            lbs = self._decision.local_batches
        elif self._quarantined:
            lbs = tuple(self.local_batches)
        else:
            lbs = None  # the builder's default rule — binary path unchanged
        self._step_fn = nt.make_ntp_train_step(
            self._cfg, self._plan, self._rank_mesh or self._mesh,
            mode=self._mode,
            local_batch=self._local_batch, optimizer=self._optimizer,
            local_batches=lbs, microbatches=self._microbatches,
            overlap=self._overlap,
        )

    def _pack(self, canonical: Dict) -> Dict:
        return nt.pack_params(self._cfg, canonical, self._plan)

    def _param_trees(self):
        """The optimizer's param-like keys, and [params, *those trees]."""
        opt_keys = [k for k in self._optimizer.param_like if k in self._opt]
        return opt_keys, [self._params] + [self._opt[k] for k in opt_keys]

    def _transition(self, old: FailurePlan, new: FailurePlan) -> None:
        """One fused packed→packed transition for params AND every
        param-like optimizer tree (AdamW m/v/master): all ride the same
        per-(replica, src, dst) messages. The ledger is kept in
        `last_transition`."""
        from repro_torch.reshard.transition import transition_trees

        opt_keys, trees = self._param_trees()
        moved, stats = transition_trees(self._cfg, trees, old, new)
        self._params = moved[0]
        self._opt = dict(self._opt, **dict(zip(opt_keys, moved[1:])))
        self.last_transition = stats

    def _transition_staged(self, old: StagedPlan, new: StagedPlan) -> None:
        """Stage-local transitions via `transition_staged_trees`: only the
        stages whose plan changed move their layers (their own
        per-(replica, src, dst) messages, tagged by stage). The session
        drops its old trees, so untouched stages pass through with zero
        bytes and no copy (``copy_unchanged=False``)."""
        from repro_torch.reshard.transition import transition_staged_trees

        opt_keys, trees = self._param_trees()
        moved, stats = transition_staged_trees(self._cfg, trees, old, new,
                                               copy_unchanged=False)
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


def _require_ntp(method: str, what: str) -> NotImplementedError:
    """The refusal of a feature the arch backend does not implement (the
    reference's ``_require_ntp`` wording), naming the public method that
    hit it and the ``what`` feature."""
    return NotImplementedError(
        f"NTPSession.{method}() needs {what}, which only the NTP prototype "
        "backend implements — this session was built with "
        "NTPSession.from_arch() (uniform training via "
        "train/steps.make_setup; a failure there is a full restart). Build "
        "the session with NTPSession.create(...) — e.g. launch/train.py "
        "--ntp instead of --arch — to use lifecycle events, canonical "
        "checkpoints, or power policies."
    )


class _ArchSession(NTPSession):
    """`NTPSession.from_arch`'s session: the arch stack's train step on one
    device, or this process's shards on a `RankMesh`; no plan, no health
    ledger."""

    @property
    def backend(self) -> str:
        return "arch"

    @property
    def setup(self):
        """The `train.steps.Setup` the session steps with (its ``model``,
        ``opt_cfg`` and ``step_fn``)."""
        return self._setup

    @property
    def optimizer(self):
        raise _require_ntp("optimizer", "a pluggable optimizer")

    @property
    def local_batches(self):
        raise _require_ntp("local_batches", "local batch accounting")

    def canonical_params(self, replica: int = 0) -> Dict:
        raise _require_ntp("canonical_params",
                           "canonical weight reconstruction")

    def step(self, batch) -> Dict[str, Any]:
        """One optimizer step on ``batch`` ({"tokens", "targets"} (B, S),
        and ``enc_input`` for an enc-dec arch; on a mesh the global batch,
        the same on every process); returns the metrics dict (loss,
        total_loss, grad_norm, lr; on a mesh equal on every process).
        Values are device tensors: reading one waits for the step. With telemetry active the step is
        a ``session.step`` span (the host's dispatch)."""
        with telemetry.get().span("session.step", backend="arch", pp=1,
                                  overlap="off"):
            self._params, self._opt, metrics = self._step_fn(
                self._params, self._opt, batch)
        return metrics

    def measure_sync(self, batch) -> Dict[str, Any]:
        raise _require_ntp("measure_sync", "sync measurement")

    def apply(self, event: LifecycleEvent):
        raise _require_ntp("apply", "lifecycle replanning")

    def save(self, path: str) -> None:
        raise _require_ntp("save", "canonical checkpointing")

    def restore(self, path: str) -> int:
        raise _require_ntp("restore", "canonical checkpointing")

    def snapshot(self) -> None:
        raise _require_ntp("snapshot", "SDC rollback snapshots")

    def rollback(self) -> int:
        raise _require_ntp("rollback", "SDC rollback snapshots")


class _RankSession(NTPSession):
    """`NTPSession` as one (replica, rank) process of a process-group run
    (`NTPSession.create(cfg, mesh=RankMesh, ...)`), or one (stage, replica,
    rank) process of a staged mesh: its own packed slots, every event kind,
    overlap on or off, per-rank snapshots."""

    def _pack(self, canonical: Dict) -> Dict:
        m = self._rank_mesh
        return nt.pack_rank_params(self._cfg, canonical, self._plan,
                                   m.replica, m.rank, nt._rank_stage(m))

    def canonical_params(self, replica: int = 0, device=None):
        """Replica ``replica``'s dense canonical weights, gathered over its
        model group (a collective of that replica's processes; on a staged
        mesh of its processes of every stage, each stage's leaves
        broadcast to the others), on ``device`` (default: the session's;
        the CPU keeps the card at one gathered leaf). Processes of other
        replicas return None and issue no collective."""
        if replica != self._rank_mesh.replica:
            return None
        return nt.unpack_rank_params(self._cfg, self._params, self._plan,
                                     self._rank_mesh, device)

    def save(self, path: str) -> None:
        """Replica 0's params and optimizer state in canonical layout
        (gathered over its model group to the host, and on a staged mesh
        over its stages), written by global rank 0 in the reference's
        format; every process returns once the file is written."""
        m = self._rank_mesh
        if m.replica == 0:
            state = {"params": self.canonical_params(0, device="cpu"),
                     "opt": {k: (nt.unpack_rank_params(
                         self._cfg, v, self._plan, m, device="cpu")
                         if k in self._optimizer.param_like else v)
                         for k, v in self._opt.items()}}
            if m.global_rank == 0:
                save_checkpoint(path, state, step=self.opt_step)
        torch.distributed.barrier()

    def restore(self, path: str) -> int:
        """Every process reads the canonical checkpoint (on a staged mesh
        only its stage's share) and packs its own slots under the CURRENT
        plan (`pack_rank_params`), no collective; equal bit for bit to the
        emulated session's `restore` sliced at this (replica, rank).
        Returns the saved step."""
        like = tr.tree_map(lambda t: t.to("meta"),
                           {"params": self._params, "opt": self._opt})
        like = {"params": self._canonical_like(like["params"]),
                "opt": {k: (self._canonical_like(v)
                            if k in self._optimizer.param_like else v)
                        for k, v in like["opt"].items()}}
        tree, step = load_checkpoint(path, like, device="cpu")
        state = {"params": self._pack(tree["params"]),
                 "opt": {k: (self._pack(v)
                             if k in self._optimizer.param_like else v)
                         for k, v in tree["opt"].items()}}
        del tree
        self._params = self._opt = None
        state = tr.tree_map(lambda t: t.to(self._device), state)
        self._params, self._opt = state["params"], state["opt"]
        return step if step is not None else self.opt_step

    def snapshot(self) -> None:
        """This process's restore point: a host copy of ITS OWN slots —
        params and every optimizer leaf — and the plan they are packed
        under. No collective."""
        self._snapshot = (self._plan, tr.tree_map(
            lambda t: t.detach().to("cpu", copy=True),
            {"params": self._params, "opt": self._opt}))

    def rollback(self) -> int:
        """Restore this process's latest `snapshot()` into the CURRENT
        plan's packing: its slots are copied back in place under the same
        plan, and otherwise moved from the snapshot's plan to the live one
        by `transition_rank_trees` (a collective of every process; pure row
        copies with zero pad slots, so the result equals `pack_rank_params`
        of the snapshot's canonical weights bit for bit). Returns the
        restored optimizer step."""
        if self._snapshot is None:
            raise RuntimeError(
                "no restore point: call session.snapshot() before relying "
                "on SDC rollback"
            )
        plan, host = self._snapshot
        live = {"params": self._params, "opt": self._opt}
        if plan == self._plan:
            with torch.no_grad():
                for t, h in zip(tr.leaves(live), tr.leaves(host)):
                    t.copy_(h)
        else:
            from repro_torch.reshard.transition import transition_rank_trees

            self._params = self._opt = live = None   # free the card first
            dev = self._device
            state = tr.tree_map(lambda t: t.to(dev, copy=True), host)
            opt = state["opt"]
            keys = [k for k in self._optimizer.param_like if k in opt]
            moved, _ = transition_rank_trees(
                self._cfg, [state["params"]] + [opt[k] for k in keys], plan,
                self._plan, self._rank_mesh)
            self._params = moved[0]
            self._opt = dict(opt, **dict(zip(keys, moved[1:])))
        self.last_rollback = True
        return self.opt_step

    def measure_sync(self, batch) -> Dict[str, Any]:
        """`NTPSession.measure_sync` on this process: ``grads_fn`` once,
        then the step's ``sync_fn`` (a collective) under a ``train.sync``
        span, timed after a barrier; ``sync_s`` is the max over every
        process, taken after the timed window."""
        step = self._step_fn
        tel = telemetry.get()
        _, grads = step.grads_fn(self._params, batch)
        label = "on" if step.overlap else "off"
        torch.distributed.barrier()
        with tel.span("train.sync", overlap=label, backend="ntp") as sp:
            sp.mark("issued")
            _sync_device(self._device)
            t0 = time.perf_counter()
            step.sync_fn(grads)
            _sync_device(self._device)
            sync_s = time.perf_counter() - t0
            sp.mark("completed")
            worst = torch.tensor([sync_s], dtype=torch.float64,
                                 device=self._device)
            torch.distributed.all_reduce(worst,
                                         op=torch.distributed.ReduceOp.MAX)
            attrs = {"collectives": int(step.collectives),
                     "sync_s": float(worst), "exposed_s": float(worst)}
            sp.set(**attrs)
        return dict(attrs, overlap=label)

    def _cost_model(self, trees):
        """`NTPSession._cost_model` from this process's slots ((buf, *unit)
        leaves, on a staged mesh only its stage's layers): the per-layer
        bytes must be every process's alike, so the verdicts (planned by
        every process on its replicated ledger) agree, and equal the
        emulated session's. Checked with one all-reduce over the job."""
        from repro_torch.cluster import TransitionCostModel

        cost = TransitionCostModel.from_rank_trees(
            self._cfg, trees, pp=self._pp,
            stage=nt._rank_stage(self._rank_mesh))
        fam = sorted(cost.family_layer_bytes.items())
        mine = torch.tensor([x for kv in fam for x in kv], dtype=torch.int64,
                            device=self._device)
        both = torch.stack([mine, -mine])
        torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX)
        if not (torch.equal(both[0], mine) and torch.equal(-both[1], mine)):
            raise AssertionError(
                f"per-layer unit bytes differ between processes: this "
                f"process {fam}, the job's max {both[0].tolist()} and min "
                f"{(-both[1]).tolist()}")
        return cost

    def _canonical_like(self, packed: Dict) -> Dict:
        """`meta` tensors of the canonical shapes of a packed rank tree."""
        units = {"attn": self._cfg.n_kv_groups, "mlp": self._cfg.k_ff}

        def leaf(path, t):
            key = tr.leaf_key(path)
            if key not in nt.UNIT_KEYS:
                return t
            k = units["mlp" if key in ("A", "B") else "attn"]
            return t.new_empty((k,) + tuple(t.shape[1:]))

        return tr.tree_map_with_path(leaf, packed)

    def _transition(self, old, new) -> None:
        """This process's slots of params and every param-like optimizer
        tree move through one all-to-all a changed stage
        (`transition_rank_trees`; on a staged mesh only the processes of
        the stages whose plan changed send anything); the ledger is the
        whole mesh's."""
        from repro_torch.reshard.transition import transition_rank_trees

        opt_keys, trees = self._param_trees()
        moved, stats = transition_rank_trees(self._cfg, trees, old, new,
                                             self._rank_mesh)
        self._params = moved[0]
        self._opt = dict(self._opt, **dict(zip(opt_keys, moved[1:])))
        self.last_transition = stats

    _transition_staged = _transition


def _sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
