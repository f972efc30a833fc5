"""Fault-tolerance policy models that serving consults (the port's copy of
the serving-facing part of `repro/core/policies.py`): the workload
geometry, the degraded-domain slowdown blends and the NTP-PW boosted
operating point. The training throughput curves wait for their slice."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.power import PowerModel


@dataclass(frozen=True)
class WorkloadGeometry:
    n_heads: int = 128
    local_batch: int = 8
    mlp_flops_share: float = 2 / 3   # d_ff = 4d ⇒ MLP ≈ 2/3 of layer FLOPs
    tp_comm_share: float = 0.15      # exposed TP-collective share of an iter


def degradation_slowdown(slow_factor: float, bw_frac: float,
                         geom: WorkloadGeometry) -> float:
    """Iteration-time multiplier of a PARTIALLY-degraded domain at full TP:
    a straggler slows the compute share ``slow_factor``× (the slowest GPU
    gates the whole TP group), a degraded link scales the exposed
    TP-collective share by 1/bw_frac. Exactly 1.0 when healthy."""
    if slow_factor == 1.0 and bw_frac == 1.0:
        return 1.0
    return float(
        (1.0 - geom.tp_comm_share) * slow_factor
        + geom.tp_comm_share / bw_frac
    )


def stage_slowdown(tp_red: int, tp_full: int, geom: WorkloadGeometry, *,
                   slow_factor: float = 1.0, bw_frac: float = 1.0) -> float:
    """Iteration-time multiplier of a TP-reduced stage at equal batch.
    MLP work redistributes evenly (128-row units, k ≫ tp — §3.1); attention
    is quantized at head granularity. Blend by FLOP share, times the
    domain's degradation multiplier (`degradation_slowdown`)."""
    if tp_red <= 0:
        return np.inf
    even = tp_full / tp_red
    heads = np.ceil(geom.n_heads / tp_red) / (geom.n_heads / tp_full)
    base = float(
        geom.mlp_flops_share * even + (1 - geom.mlp_flops_share) * heads
    )
    dm = degradation_slowdown(slow_factor, bw_frac, geom)
    return base if dm == 1.0 else base * dm


def boosted_operating_point(slow: float, power: PowerModel):
    """NTP-PW operating point for one stage at slowdown ``slow`` (Table 1
    convention): boost just enough to erase the whole slowdown, capped by
    the rack (§3.2). Returns (power_mult, residual_slowdown) — residual 1.0
    when within the cap."""
    p = min(power.required_power_for_speedup(slow), power.max_boost)
    return float(p), float(slow / power.speedup(p))
