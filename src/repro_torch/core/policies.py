"""Fault-tolerance policy throughput models: DP-DROP vs NTP vs NTP-PW
(paper §6.1, Figs. 6/7/10) — the port's copy of `repro/core/policies.py`.

All policies share the cluster geometry of §5.3: 32K GPUs, 32-wide scale-up
domains at TP32, 8 domains per DP replica (PP8), 128 DP replicas, 128
attention heads, local batch 8. Host-side numpy: the analytic values equal
the reference's (`tests/golden/analytic_golden.json`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.core.availability import ClusterSpec, sample_failed_domains
from repro_torch.core.power import PowerModel
from repro_torch.core.resource_manager import apply_spares, pack_replicas


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


def staged_rel_iter_times(
    stage_tp,
    tp_full: int,
    geom: WorkloadGeometry,
    *,
    local_batches,
    local_batch: int,
    boosts=None,
    power: PowerModel = PowerModel(),
    slow_factors=None,
    bw_fracs=None,
):
    """Per-STAGE predicted relative iteration time of a DP×PP×TP job:
    ``stage_tp[d][s]`` is replica d's surviving TP in pipeline stage s.
    Stage s's relative busy time is

        rel_s = max_d  slowdown(tp[d][s]) / speedup(boost_d) · lb_d / LB

    with the power boost applied only where the stage is actually degraded
    (the repurposed budget lives in the degraded domain's rack). The job's
    relative iteration time is ``max_s rel_s`` — the slowest stage gates the
    pipeline (the reference's `perf_model.staged_iteration_time` reduction) —
    and equals `PowerDecision.rel_iter_time` computed on the plan's
    effective (min-over-stages) TP.

    ``slow_factors``/``bw_fracs`` are per-REPLICA degradation factors
    (`StagedHealth.replica_degradations`, already merged across stages —
    1F1B runs every microbatch through every stage, so a straggler anywhere
    gates the replica in every stage)."""
    d_axis = len(stage_tp)
    pp = len(stage_tp[0])
    if boosts is None:
        boosts = (1.0,) * d_axis
    if slow_factors is None:
        slow_factors = (1.0,) * d_axis
    if bw_fracs is None:
        bw_fracs = (1.0,) * d_axis
    rels = []
    for s in range(pp):
        r_s = 0.0
        for d in range(d_axis):
            tp = stage_tp[d][s]
            degraded = slow_factors[d] != 1.0 or bw_fracs[d] != 1.0
            if tp == tp_full and not degraded:
                eff = 1.0
            else:
                slow = stage_slowdown(
                    tp, tp_full, geom,
                    slow_factor=slow_factors[d], bw_frac=bw_fracs[d],
                )
                eff = slow / power.speedup(boosts[d])
            r_s = max(r_s, eff * local_batches[d] / local_batch)
        rels.append(float(r_s))
    return tuple(rels)


def boosted_operating_point(slow: float, power: PowerModel):
    """NTP-PW operating point for one stage at slowdown ``slow`` (Table 1
    convention): boost just enough to erase the whole slowdown, capped by
    the rack (§3.2). Returns (power_mult, residual_slowdown) — residual 1.0
    when within the cap."""
    p = min(power.required_power_for_speedup(slow), power.max_boost)
    return float(p), float(slow / power.speedup(p))


def replica_throughput(
    tp_red: int,
    tp_full: int,
    geom: WorkloadGeometry,
    method: str,
    power: PowerModel,
    *,
    slow_factor: float = 1.0,
    bw_frac: float = 1.0,
) -> float:
    """Relative samples/iteration of one DP replica whose weakest stage runs
    at tp_red (1.0 = healthy). NTP: shrink local batch to not straggle.
    NTP-PW: boost power to keep full batch; fall back to batch shrink past
    the boost cap. ``slow_factor``/``bw_frac`` price the replica's
    degradation ledger on top of its TP reduction — a straggling full-TP replica is degraded too."""
    if tp_red <= 0:
        return 0.0
    if tp_red == tp_full and slow_factor == 1.0 and bw_frac == 1.0:
        return 1.0
    slow = stage_slowdown(tp_red, tp_full, geom,
                          slow_factor=slow_factor, bw_frac=bw_frac)
    if method == "ntp":
        bs = int(np.floor(geom.local_batch / slow))
        return bs / geom.local_batch
    if method == "ntp_pw":
        # the rack is provisioned for up to max_boost on every survivor
        # (§3.2; Table 1 boosts TP30 to 1.15× > 32/30× of the failed share)
        speed = power.speedup(power.max_boost)
        eff_slow = slow / speed
        if eff_slow <= 1.0 + 1e-9:
            return 1.0
        bs = int(np.floor(geom.local_batch / eff_slow))
        return bs / geom.local_batch
    raise ValueError(method)


def table1_settings(
    geom: WorkloadGeometry = WorkloadGeometry(), power: PowerModel = PowerModel()
):
    """Reproduce Table 1 analytically (TP32 domain, local bs 8): non-boosted
    reduced-TP replicas shrink local batch to not straggle; boosted ones keep
    bs=8 and raise power until iteration time matches."""
    rows = []
    base_tp, base_bs = 32, geom.local_batch
    for tp in (32, 30, 28):
        slow = stage_slowdown(tp, base_tp, geom)
        bs = min(base_bs, int(np.floor(base_bs / slow)))
        rows.append({
            "config": f"TP{tp}", "local_bs": bs, "power": 1.0,
            "rel_iter_time": round(slow * bs / base_bs, 3),
        })
        if tp != base_tp:
            preq, rel = boosted_operating_point(slow, power)
            rows.append({
                "config": f"TP{tp}-PW", "local_bs": base_bs,
                "power": round(preq, 2), "rel_iter_time": round(rel, 3),
            })
    return rows


def cluster_throughput(
    spec: ClusterSpec,
    failed_counts: np.ndarray,
    method: str,
    *,
    geom: WorkloadGeometry = WorkloadGeometry(),
    power: PowerModel = PowerModel(),
    n_spare_domains: int = 0,
) -> Dict:
    """Relative cluster samples/iteration under one failure sample.

    DP-DROP reforms replicas from fully-clean domains (the favourable
    variant — dropping whole original replicas would be strictly worse).
    """
    failed = apply_spares(failed_counts, n_spare_domains)
    n_domains = len(failed)
    n_replicas = n_domains // spec.domains_per_replica

    if method == "dpdrop":
        clean = int((failed == 0).sum())
        usable = clean // spec.domains_per_replica
        thr = usable / n_replicas
        return {"throughput": thr, "replica_throughputs": None,
                "lost_fraction": 1.0 - thr}

    assignments = pack_replicas(failed, spec.domain_size, spec.domains_per_replica)
    thr = [
        replica_throughput(a.tp, spec.domain_size, geom, method, power)
        for a in assignments
    ]
    total = float(np.sum(thr)) / n_replicas
    return {
        "throughput": total,
        "replica_throughputs": thr,
        "lost_fraction": 1.0 - total,
        "affected_replicas": sum(1 for t in thr if t < 1.0),
    }


def throughput_loss_curve(
    spec: ClusterSpec,
    failed_fractions,
    methods=("dpdrop", "ntp", "ntp_pw"),
    *,
    samples: int = 20,
    blast_radius: int = 1,
    seed: int = 0,
    geom: WorkloadGeometry = WorkloadGeometry(),
) -> Dict[str, List[float]]:
    """Fig. 6 / Fig. 10: mean lost-throughput fraction per failed fraction."""
    rng = np.random.default_rng(seed)
    out: Dict[str, List[float]] = {m: [] for m in methods}
    for f in failed_fractions:
        n_failed = int(round(f * spec.n_gpus))
        losses = {m: [] for m in methods}
        for _ in range(samples):
            counts = sample_failed_domains(
                spec.n_gpus, spec.domain_size, n_failed, rng, blast_radius
            )
            for m in methods:
                losses[m].append(
                    cluster_throughput(spec, counts, m, geom=geom)["lost_fraction"]
                )
        for m in methods:
            out[m].append(float(np.mean(losses[m])))
    return out


def spares_analysis(
    spec: ClusterSpec,
    failed_domain_trace: List[np.ndarray],
    spare_range,
    method: str,
    *,
    geom: WorkloadGeometry = WorkloadGeometry(),
) -> List[Dict]:
    """Fig. 7: fixed minibatch — training PAUSES whenever the surviving
    replicas (+ spare replicas) cannot supply the full minibatch. Returns
    per-spare-count {spares, uptime, throughput_per_gpu}."""
    out = []
    n_replicas = (spec.n_gpus // spec.domain_size) // spec.domains_per_replica
    for s in spare_range:
        ok_time = 0
        for counts in failed_domain_trace:
            res = cluster_throughput(
                spec, counts, method if method != "dpdrop" else "dpdrop",
                geom=geom, n_spare_domains=s,
            )
            if method == "dpdrop":
                maintained = res["throughput"] >= 1.0 - 1e-9
            else:
                # lost sample capacity must be covered by whole spare replicas
                lost_replica_equiv = (1.0 - res["throughput"]) * n_replicas
                spare_replicas = s // spec.domains_per_replica
                maintained = spare_replicas >= np.ceil(lost_replica_equiv - 1e-9)
            ok_time += int(maintained)
        uptime = ok_time / max(len(failed_domain_trace), 1)
        total_gpus = spec.n_gpus + s * spec.domain_size
        out.append({
            "spares": int(s),
            "uptime": uptime,
            "throughput_per_gpu": uptime * spec.n_gpus / total_gpus,
        })
    return out
