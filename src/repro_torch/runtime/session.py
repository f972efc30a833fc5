"""NTPSession — the runtime entry point for training under failures (port of
`repro/runtime/session.py` for the NTP prototype at pp=1).

Session lifecycle::

    session = NTPSession.create(cfg, (2, 4), local_batch=4,
                                optimizer=optim.adamw(AdamWConfig(lr=1e-2)))
    for i, batch in ...:
        if gpu_died:
            session.apply(FailureEvent(step=i, replica=r))   # replan in place
        if gpu_repaired:
            session.apply(RecoveryEvent(step=i, replica=r))  # TP back up
        metrics = session.step(batch)                        # loss, grad_norm

The (data, model) mesh is emulated on one device (`core.ntp_train`).
`apply()` moves params AND optimizer state through the direct packed→packed
transition (`reshard.transition`) on the device: only units whose rank
changes move, fused into one message per (replica, src, dst)
(``session.last_transition`` has the ledger). A `FailureEvent` lowers a
replica's TP, a `RecoveryEvent` raises it back.

Not ported yet (each raises `NotImplementedError` naming its ROADMAP row):
the PowerPolicy, spare domains and the global allocator, pp>1, SDC
quarantine and rollback, canonical checkpoints (`save`/`restore`) and the
uniform arch backend (`from_arch`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import ntp_train as nt
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.core.ntp_train import Mode, NTPModelConfig
from repro_torch.core.overlap import coerce_overlap
from repro_torch.kernels import mode as kmode
from repro_torch.optim import AdamWConfig, Optimizer, adamw
from repro_torch.runtime.events import (
    ClusterHealth, FailureEvent, LifecycleEvent, RecoveryEvent,
    plan_from_health,
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
        power_policy=None,
        spares: int = 0,
        pp: int = 1,
        microbatches: int = 1,
        allocator=None,
    ) -> "NTPSession":
        """NTP-prototype session on an emulated (data=D, model=N1) mesh
        ``mesh``, on ``device`` (CUDA unless ``device="cpu"``). ``health``
        and/or ``plan`` seed the failure state (default: pristine).
        ``params`` are canonical weights (default: drawn from ``generator``
        by `ntp_train.init_canonical`)."""
        if power_policy is not None:
            raise _not_ported("the PowerPolicy (NTP-PW boosts)",
                              "'session policies'")
        if spares or allocator is not None:
            raise _not_ported("spare domains and the global allocator",
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
        self._overlap = coerce_overlap(overlap)
        self.last_transition = None   # TransferStats of the latest repack
        d, n1 = (int(x) for x in mesh)
        self._mesh = (d, n1)
        if health is None:
            health = (ClusterHealth.from_plan(plan) if plan is not None
                      else ClusterHealth.pristine(d, n1))
        self._health = health
        packed = plan_from_health(health)
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
    def overlap(self) -> bool:
        """Whether the step runs the overlapped, bucketed gradient sync."""
        return self._overlap

    @property
    def events(self) -> List[LifecycleEvent]:
        return list(self._events)

    @property
    def local_batches(self):
        """Per-replica usable samples under the current plan."""
        return [int(b) for b in nt.default_local_batches(
            self._plan, self._mode, self._local_batch)]

    @property
    def params(self):
        """The live packed parameter tree."""
        return self._params

    @property
    def opt_state(self):
        return self._opt

    @property
    def opt_step(self) -> int:
        return int(self._opt["step"])

    @property
    def step_fn(self):
        """The step for the current plan (carries ``.collectives`` and the
        other probes of the step builders)."""
        return self._step_fn

    def canonical_params(self, replica: int = 0) -> Dict:
        """Dense canonical weights recovered from one replica."""
        return nt.unpack_params(self._cfg, self._params, self._plan,
                                replica=replica)

    # ---------------------------------------------------------------- train

    def step(self, batch) -> Dict[str, Any]:
        """One optimizer step on the global (D*local_batch, S+1) token
        array; returns the metrics dict (loss, grad_norm, lr). Values are
        device tensors: reading one waits for the step."""
        self._params, self._opt, metrics = self._step_fn(
            self._params, self._opt, batch)
        return metrics

    # ---------------------------------------------------------------- events

    def apply(self, event: LifecycleEvent) -> FailurePlan:
        """Consume a `FailureEvent` or `RecoveryEvent`: update health,
        replan, and move params and optimizer state into the new plan —
        training continues with the same logical weights. Returns the new
        plan."""
        if not isinstance(event, (FailureEvent, RecoveryEvent)):
            raise _not_ported(
                f"{type(event).__name__} (the degradation kinds)",
                "'session policies'")
        new_health = self._health.apply(event)
        new_plan = plan_from_health(new_health)
        self._events.append(event)
        self._health = new_health
        if new_plan == self._plan:
            return self._plan
        self._transition(self._plan, new_plan)
        self._plan = new_plan
        if self._mode is Mode.UNIFORM and not new_plan.healthy:
            self._mode = Mode.NTP  # uniform degrades into NTP, not death
        self._build_step()
        return new_plan

    def save(self, path: str) -> None:
        raise _not_ported("canonical checkpointing (save)", "'checkpoint'")

    def restore(self, path: str) -> int:
        raise _not_ported("canonical checkpointing (restore)", "'checkpoint'")

    def snapshot(self) -> None:
        raise _not_ported("SDC snapshots", "'session quarantine'")

    def rollback(self) -> int:
        raise _not_ported("SDC rollback", "'session quarantine'")

    # ---------------------------------------------------------------- private

    def _build_step(self) -> None:
        self._step_fn = nt.make_ntp_train_step(
            self._cfg, self._plan, self._mesh, mode=self._mode,
            local_batch=self._local_batch, optimizer=self._optimizer,
            overlap=self._overlap,
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
