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
slot map in place and hands back whatever was preempted. Degradations
(stragglers, degraded links, SDC suspicions) drain-then-retarget instead:
the replica keeps its TP and cache, its decode rate is repriced, and an
open SDC suspicion drains it (``quarantine``). Every apply records a
``serve.transition`` span; `save`/`restore` checkpoint the KV-bearing
state through `repro_torch.checkpoint`, restorable under any TP.
"""
from __future__ import annotations

from dataclasses import replace as _replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch import tree as tr
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.core.nonuniform import FailurePlan
from repro_torch.core.policies import WorkloadGeometry
from repro_torch.core.power import PowerModel
from repro_torch.models.transformer import build_model
from repro_torch.reshard.units import serve_unit_count
from repro_torch.runtime.events import (
    DEGRADATION_EVENTS, ClusterHealth, LifecycleEvent, RecoveryEvent,
    event_kind, resolve_serving_domain,
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
        quarantine: bool = True,
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
        self._events: List[LifecycleEvent] = []
        self._repair_debt: Dict[int, int] = {}   # domain -> clamp surplus
        self._quarantine = quarantine
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
    def quarantine(self) -> bool:
        """Whether an open SDC suspicion drains its replica."""
        return self._quarantine

    @property
    def health(self) -> ClusterHealth:
        return self._health

    @property
    def events(self) -> List[LifecycleEvent]:
        return list(self._events)

    @property
    def replica_tp(self) -> Tuple[int, ...]:
        """Surviving TP degree per (domain-pinned) serving replica."""
        return tuple(self._n1 - f for f in self._health.failed)

    @property
    def plan(self) -> Optional[FailurePlan]:
        """The session's health as a `FailurePlan` (None while any replica
        is fully dead: a plan has no TP-0 replica)."""
        tp = self.replica_tp
        if any(t < 1 for t in tp):
            return None
        return FailurePlan(n1=self._n1, replica_tp=tp)

    def total_rate(self) -> float:
        """Upper-bound decode tokens per wall tick across live replicas."""
        return float(sum(e.rel_speed * e.capacity for e in self.engines))

    # ---------------------------------------------------------------- events

    def _operating_point(self, tp: int, deg=None) -> Tuple[int, float, float]:
        """(engine_tp, rel_speed, power_boost) the policy assigns to a
        replica whose domain has ``tp`` surviving GPUs; ``deg`` is the
        domain's `DomainDegradation` ledger (stragglers and degraded links
        slow the replica instead of dropping it)."""
        speed, boost = replica_serve_speed(
            tp, self._n1, self._policy, geom=self._geom, power=self._power,
            slow_factor=deg.slow_factor if deg is not None else 1.0,
            bw_frac=deg.bw_frac if deg is not None else 1.0,
        )
        if speed == 0.0:  # tp 0, or drop policy with any failure: dead
            return 0, 0.0, 1.0
        return tp, speed, boost

    def apply(self, event: LifecycleEvent) -> List[Request]:
        """Consume a lifecycle event: update the ledger, retarget every
        affected engine (KV reshard / death / revival + speed + slot map),
        and return the preempted requests for the router to requeue.

        Failures beyond a domain's size clamp in the ledger but leave a
        per-domain repair DEBT, and the matching surplus repairs are
        absorbed against it — otherwise a fully-dead replica would revive
        while its trace still has every GPU down.

        Degradation events go to `_apply_degradation` (drain-then-retarget:
        nothing is preempted)."""
        event = resolve_serving_domain(event, self._health.n_domains)
        dom = event.domain
        if isinstance(event, DEGRADATION_EVENTS):
            return self._apply_degradation(event, dom)
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
        self._events.append(event)
        degs = self._health.replica_degradations()
        preempted: List[Request] = []
        tel = telemetry.get()
        with tel.span("serve.transition", kind=event_kind(event),
                      policy=self._policy) as sp:
            reshard_bytes = 0
            for r, engine in enumerate(self.engines):
                tp, speed, boost = self._operating_point(
                    self.replica_tp[r], degs[r]
                )
                if tp == engine.tp and not (engine.dead and tp > 0):
                    engine.rel_speed, engine.power_boost = speed, boost
                    continue
                pre = engine.apply_tp(tp, rel_speed=speed, power_boost=boost)
                preempted += pre
                reshard_bytes += engine.last_reshard.get("bytes_moved", 0)
                self.transitions.append({
                    "event": event, "replica": r,
                    "tp_from": old_tp[r], "tp_to": tp,
                    "preempted": len(pre),
                    "power_boost": boost, "rel_speed": speed,
                    "reshard": dict(engine.last_reshard),
                })
            sp.set(domain=dom, preempted=len(preempted),
                   bytes_moved=reshard_bytes)
            if tel.enabled:
                if preempted:
                    tel.counter("serve.preempted", len(preempted),
                                policy=self._policy)
                self._rate_gauges(tel)
        return preempted

    def _apply_degradation(self, event, dom: int) -> List[Request]:
        """Drain-then-retarget: the TP, cache layout and slot pool are
        untouched (a degradation removes no GPU), so nothing is preempted;
        every live engine's decode rate is repriced through the updated
        ledger, and an open SDC suspicion sets ``draining`` (in-flight
        requests finish, nothing new is admitted) until its clear. Returns
        [] (`apply`'s preempted list)."""
        self._health = self._health.apply(event)
        self._events.append(event)
        degs = self._health.replica_degradations()
        tel = telemetry.get()
        with tel.span("serve.transition", kind=event_kind(event),
                      policy=self._policy) as sp:
            for r, engine in enumerate(self.engines):
                if engine.dead:
                    continue
                _, speed, boost = self._operating_point(
                    self.replica_tp[r], degs[r]
                )
                draining = self._quarantine and degs[r].sdc > 0
                changed = (speed != engine.rel_speed
                           or boost != engine.power_boost
                           or draining != engine.draining)
                engine.rel_speed, engine.power_boost = speed, boost
                engine.draining = draining
                if changed:
                    self.transitions.append({
                        "event": event, "replica": r, "kind": "retarget",
                        "tp_from": engine.tp, "tp_to": engine.tp,
                        "preempted": 0, "power_boost": boost,
                        "rel_speed": speed, "draining": draining,
                    })
            sp.set(domain=dom, preempted=0)
            if tel.enabled:
                self._rate_gauges(tel)
        return []

    def _rate_gauges(self, tel) -> None:
        for r, engine in enumerate(self.engines):
            tel.gauge("serve.replica_rate",
                      engine.rel_speed * engine.capacity, replica=str(r))

    # ------------------------------------------------------------------ run

    def tick(self) -> List[Request]:
        """One wall tick on every live engine; returns finished requests."""
        done: List[Request] = []
        for e in self.engines:
            done += e.tick()
        return done

    # ------------------------------------------------------------ checkpoint

    @staticmethod
    def _engine_state(e) -> Dict:
        """One engine's KV-bearing state: the dense cache (by cache group,
        on the engine's device), the slot tables and the in-flight request
        bodies (prompt and generated prefix, padded to max_len) as int32
        CPU tensors — a restored session must be able to name the request
        behind every live slot."""
        ml = e.max_len
        prompt = np.zeros((e.slots, ml), np.int32)
        p_len = np.zeros(e.slots, np.int32)
        gen = np.zeros((e.slots, ml), np.int32)
        g_len = np.zeros(e.slots, np.int32)
        max_new = np.zeros(e.slots, np.int32)
        for b in np.flatnonzero(e._rid >= 0):
            req = e._req[int(e._rid[b])]
            prompt[b, : len(req.prompt)] = req.prompt
            p_len[b] = len(req.prompt)
            gen[b, : len(req.generated)] = req.generated
            g_len[b] = len(req.generated)
            max_new[b] = req.max_new
        tables = {
            "rid": e._rid, "pos": e._pos, "cur_tok": e._cur_tok,
            "admit_order": e._admit_order, "admitted": e._admitted,
            "req_prompt": prompt, "req_prompt_len": p_len,
            "req_gen": gen, "req_gen_len": g_len, "req_max_new": max_new,
        }
        state = {k: torch.as_tensor(np.asarray(v, np.int32))
                 for k, v in tables.items()}
        state["kv"] = e.cache
        return state

    @staticmethod
    def _weights_fingerprint(params) -> torch.Tensor:
        """What a weightless checkpoint keeps of the weights its caches
        were computed with: per leaf, in tree order, its rank, its shape
        and the bits of 8 of its values at a fixed stride. Exact on any
        device, and a few kB to read at any model size."""
        heads, samples = [], []
        for _, leaf in tr.leaves_with_path(params):
            flat = leaf.detach().reshape(-1)
            idx = torch.arange(8) * (flat.numel() - 1) // 7
            samples.append(flat[idx.to(flat.device)].float())
            heads.append([leaf.dim(), *leaf.shape])
        bits = torch.stack(samples).cpu().view(torch.int32).long()
        return torch.cat([torch.cat([torch.tensor(h), b])
                          for h, b in zip(heads, bits)])

    def save(self, path: str, *, weights: bool = True) -> None:
        """Write the KV-bearing state: every replica's dense
        (layout-independent) cache, slot tables and in-flight request
        bodies, and the weights unless ``weights=False`` (a session
        restoring onto the same weights need not read them back; the
        file then holds their `_weights_fingerprint`, which `restore`
        checks). bf16 caches round-trip through the checkpoint's dtype
        records. The router's queue is not saved: queued requests were
        never admitted, so resubmitting them is safe."""
        tree = {"engines": [self._engine_state(e) for e in self.engines]}
        if weights:
            tree["params"] = self._params
        else:
            tree["weights_fingerprint"] = self._weights_fingerprint(
                self._params)
        save_checkpoint(path, tree)

    def restore(self, path: str) -> List[Request]:
        """Load a `save` checkpoint into the CURRENT per-replica layouts: a
        checkpoint taken under one TP restores under any other (the dense
        cache is canonical). In-flight requests are rebuilt and decoding
        continues where it stopped (arrival and deadline reset). The
        session's OWN in-flight requests are preempted first, and returned
        with any checkpointed slot beyond a degraded replica's current
        capacity — nothing is dropped silently. Weights are restored when
        the checkpoint holds them; a weightless checkpoint restores only
        into a session whose weights match its fingerprint (ValueError
        otherwise, before anything is preempted)."""
        with np.load(path) as data:
            weights = any(k.startswith("params/") for k in data.files)
            saved = (data["weights_fingerprint"]
                     if "weights_fingerprint" in data.files else None)
        if not weights:
            own = self._weights_fingerprint(self._params).numpy()
            if saved is None or not np.array_equal(saved, own):
                raise ValueError(
                    f"checkpoint {path} holds no weights and "
                    + ("no fingerprint of them" if saved is None else
                       "was taken on other weights than this session's")
                    + ": restore it into a session sharing its weights")
        like = {"engines": [self._engine_state(e) for e in self.engines]}
        if weights:
            like["params"] = self._params
        tree, _ = load_checkpoint(path, like)
        preempted: List[Request] = []
        for e in self.engines:
            while e.n_active:
                preempted.append(e._preempt_one())
        if weights:
            self._params = tree["params"]
        for r, e in enumerate(self.engines):
            st = {k: v if k == "kv" else v.numpy()
                  for k, v in tree["engines"][r].items()}
            e.params = self._params
            e._cache = st["kv"]
            for k, attr in (("rid", "_rid"), ("pos", "_pos"),
                            ("cur_tok", "_cur_tok"),
                            ("admit_order", "_admit_order")):
                setattr(e, attr, st[k].astype(np.int64))
            e._admitted = int(st["admitted"])
            e._req = {}
            for b in np.flatnonzero(e._rid >= 0):
                p_len = int(st["req_prompt_len"][b])
                g_len = int(st["req_gen_len"][b])
                req = Request(
                    rid=int(e._rid[b]),
                    prompt=st["req_prompt"][b][:p_len].astype(np.int32),
                    max_new=int(st["req_max_new"][b]),
                    generated=[int(t) for t in st["req_gen"][b][:g_len]],
                )
                e._req[req.rid] = req
            while e.n_active > e.capacity:
                preempted.append(e._preempt_one())
        return preempted
