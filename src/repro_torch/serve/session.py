"""ServeSession — the serving façade (port of `repro/serve/session.py`).

One session owns D serving replicas (one `ServeEngine` each, sharing one
weight copy), the per-domain failed-GPU ledger (`runtime.events.ClusterHealth`)
and the fault-tolerance policy deciding what a degraded replica does:

* ``drop``   — any failure kills the whole replica (in-flight requests
  preempted, cache lost) until its domain is fully repaired.
* ``ntp``    — the replica keeps serving at reduced TP: its cache (KV
  heads, or Mamba-2 SSD heads) is resharded in place
  (`reshard.ShardedState`), decode slowed by the
  unit-quantized `stage_slowdown`, slot pool shrunk ∝ surviving ranks.
* ``ntp_pw`` — NTP plus the paper's §3.2 power boost
  (`policies.boosted_operating_point`).

Replica ``r`` serves domain ``r``; `apply(event)` reshards KV cache and
slot map in place and hands back whatever was preempted. Save/restore,
telemetry and the degradation kinds wait for their slices.
"""
from __future__ import annotations

from dataclasses import replace as _replace
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policies import WorkloadGeometry
from repro_torch.core.power import PowerModel
from repro_torch.models.transformer import build_model
from repro_torch.reshard.units import serve_unit_count
from repro_torch.runtime.events import (
    ClusterHealth, LifecycleEvent, RecoveryEvent, resolve_serving_domain,
)
from repro_torch.serve.engine import Request, ServeEngine, validate_serve_cfg
from repro_torch.serve.router import SERVE_GEOM, replica_serve_speed

SERVE_POLICIES = ("drop", "ntp", "ntp_pw")


class ServeSession:
    """Stateful serving session: D engines + health ledger + policy."""

    def __init__(self, *_, **__):
        raise TypeError("use ServeSession.create(...)")

    @classmethod
    def create(
        cls,
        cfg: ArchConfig,
        *,
        replicas: int = 1,
        n1: int = 4,
        slots: int = 8,
        max_len: int = 96,
        prefill_len: int = 32,
        policy: str = "ntp",
        power_model: PowerModel = PowerModel(),
        geom: Optional[WorkloadGeometry] = None,
        dtype=torch.float32,
        params=None,
        seed: int = 0,
        device=None,
    ) -> "ServeSession":
        """``params`` shares an existing weight dict (no copy); without it
        the weights are drawn from a `torch.Generator` seeded with ``seed``
        on the session's device (CUDA unless ``device="cpu"``)."""
        if policy not in SERVE_POLICIES:
            raise ValueError(f"policy {policy!r} not in {SERVE_POLICIES}")
        validate_serve_cfg(cfg)
        model = build_model(cfg, device=device)   # validates cfg
        self = object.__new__(cls)
        self._cfg = cfg
        self._policy = policy
        self._power = power_model
        # decode quantizes at the model's COARSEST partition-unit family
        # (KV heads / SSD heads), with the analytic model's decode-time
        # FLOP split
        self._geom = geom or _replace(
            SERVE_GEOM, n_heads=serve_unit_count(cfg), local_batch=slots
        )
        if params is None:
            gen = torch.Generator(device=model.device).manual_seed(seed)
            params = model.init(gen)
        self._params = params
        self._health = ClusterHealth.pristine(replicas, n1)
        self._n1 = n1
        self.engines = [
            ServeEngine(cfg, params, n1=n1, slots=slots, max_len=max_len,
                        prefill_len=prefill_len, dtype=dtype, model=model)
            for _ in range(replicas)
        ]
        self._repair_debt: Dict[int, int] = {}   # domain -> clamp surplus
        self.transitions: List[Dict] = []
        return self

    # ------------------------------------------------------------ introspect

    @property
    def cfg(self) -> ArchConfig:
        return self._cfg

    @property
    def params(self):
        return self._params

    @property
    def device(self) -> torch.device:
        return self.engines[0].device

    @property
    def policy(self) -> str:
        return self._policy

    @property
    def health(self) -> ClusterHealth:
        return self._health

    @property
    def replica_tp(self) -> Tuple[int, ...]:
        """Surviving TP degree per (domain-pinned) serving replica."""
        return tuple(self._n1 - f for f in self._health.failed)

    def total_rate(self) -> float:
        """Upper-bound decode tokens per wall tick across live replicas."""
        return float(sum(e.rel_speed * e.capacity for e in self.engines))

    # ---------------------------------------------------------------- events

    def _operating_point(self, tp: int) -> Tuple[int, float, float]:
        """(engine_tp, rel_speed, power_boost) the policy assigns to a
        replica whose domain has ``tp`` surviving GPUs."""
        speed, boost = replica_serve_speed(
            tp, self._n1, self._policy, geom=self._geom, power=self._power,
        )
        if speed == 0.0:  # tp 0, or drop policy with any failure: dead
            return 0, 0.0, 1.0
        return tp, speed, boost

    def apply(self, event: LifecycleEvent) -> List[Request]:
        """Consume a failure or repair: update the ledger, retarget every
        affected engine (KV reshard / death / revival + speed + slot map),
        and return the preempted requests for the router to requeue.

        Failures beyond a domain's size clamp in the ledger but leave a
        per-domain repair DEBT, and the matching surplus repairs are
        absorbed against it — otherwise a fully-dead replica would revive
        while its trace still has every GPU down."""
        event = resolve_serving_domain(event, self._health.n_domains)
        dom = event.domain
        if isinstance(event, RecoveryEvent):
            debt = self._repair_debt.get(dom, 0)
            absorbed = min(debt, event.n_gpus)
            if absorbed:
                self._repair_debt[dom] = debt - absorbed
                if absorbed == event.n_gpus:
                    self.transitions.append({
                        "event": event, "replica": dom, "kind": "absorbed",
                        "tp_from": self.replica_tp[dom],
                        "tp_to": self.replica_tp[dom], "preempted": 0,
                    })
                    return []
                event = RecoveryEvent(step=event.step, domain=dom,
                                      n_gpus=event.n_gpus - absorbed)
        else:
            overflow = self._health.failed[dom] + event.n_gpus - self._n1
            if overflow > 0:
                self._repair_debt[dom] = (
                    self._repair_debt.get(dom, 0) + overflow
                )
        old_tp = self.replica_tp
        self._health = self._health.apply(event)
        preempted: List[Request] = []
        for r, engine in enumerate(self.engines):
            tp, speed, boost = self._operating_point(self.replica_tp[r])
            if tp == engine.tp and not (engine.dead and tp > 0):
                engine.rel_speed, engine.power_boost = speed, boost
                continue
            pre = engine.apply_tp(tp, rel_speed=speed, power_boost=boost)
            preempted += pre
            self.transitions.append({
                "event": event, "replica": r,
                "tp_from": old_tp[r], "tp_to": tp,
                "preempted": len(pre),
                "power_boost": boost, "rel_speed": speed,
                "reshard": dict(engine.last_reshard),
            })
        return preempted

    # ------------------------------------------------------------------ run

    def tick(self) -> List[Request]:
        """One wall tick on every live engine; returns finished requests."""
        done: List[Request] = []
        for e in self.engines:
            done += e.tick()
        return done
