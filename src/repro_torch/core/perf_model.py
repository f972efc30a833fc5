"""Analytic hybrid-parallel performance model (paper §4.2; port of
`repro/core/perf_model.py`, numpy only): a closed-form iteration-time model
with compute / TP-collective / PP-bubble / DP-allreduce / NTP-reshard
terms. Its results equal the reference's exactly. The pipeline bubble of
the port's emulated staged step is this model's, not a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional


@dataclass(frozen=True)
class Hardware:
    chip_flops: float = 197e12        # bf16 peak / chip
    hbm_bw: float = 819e9
    scaleup_bw: float = 9e11          # per-GPU intra-domain (NVL/ICI) bytes/s
    scaleout_bw: float = 1e11         # per-GPU inter-domain bytes/s
    domain_size: int = 32
    mfu_ceiling: float = 0.62         # achievable matmul efficiency


@dataclass(frozen=True)
class Workload:
    n_params: float = 480e9
    n_layers: int = 100
    d_model: int = 20480
    seq_len: int = 16384
    minibatch_tokens: float = 16e6
    act_bytes: int = 2


@dataclass(frozen=True)
class Parallel:
    tp: int = 32
    pp: int = 8
    dp: int = 128
    microbatch_seqs: int = 1

    @property
    def gpus(self) -> int:
        return self.tp * self.pp * self.dp


def iteration_time(
    hw: Hardware,
    wl: Workload,
    par: Parallel,
    *,
    tp_reduced: Optional[int] = None,
    local_batch_scale: float = 1.0,
    power_speedup: float = 1.0,
    dp_overlap: float = 0.7,
    tp_overlap: float = 0.3,
    reshard_overlap: Optional[float] = None,
    slow_factor: float = 1.0,
    link_bw_frac: float = 1.0,
) -> Dict[str, float]:
    """Per-iteration time breakdown for ONE DP replica (seconds).

    tp_reduced: NTP — this replica's stages run at a reduced TP degree
    (same work on fewer chips). local_batch_scale scales its sample count.
    power_speedup: NTP-PW compute boost.
    reshard_overlap: None keeps the legacy Fig.-8 heuristic (90% of the
    reshard hidden); an explicit fraction exposes ``(1 - reshard_overlap)``
    of it — `overlap_iteration_time` passes 0.0 to start from a fully
    exposed sync before applying its own overlap window.
    slow_factor: health-state taxonomy (DESIGN.md §2.11) — a straggling
    domain gates its whole TP group, priced the way the bubble is: an
    additive ``straggler_exposed = (compute + tp_exposed) · (slow − 1)``
    term on the busy time. link_bw_frac scales the scale-up bandwidth every
    intra-domain collective (TP, reshard) sees.
    """
    if slow_factor < 1.0:
        raise ValueError(f"slow_factor {slow_factor} < 1")
    if not 0.0 < link_bw_frac <= 1.0:
        raise ValueError(f"link_bw_frac {link_bw_frac} outside (0, 1]")
    # ``* 1.0`` is bit-exact: the healthy path's floats are unchanged
    hw = replace(hw, scaleup_bw=hw.scaleup_bw * link_bw_frac)
    tp_eff = tp_reduced or par.tp
    tokens_per_replica = wl.minibatch_tokens / par.dp * local_batch_scale
    seqs = max(tokens_per_replica / wl.seq_len, 1e-9)
    m = max(int(round(seqs / par.microbatch_seqs)), 1)

    # ---- compute ----------------------------------------------------------
    flops_replica = 6.0 * wl.n_params * tokens_per_replica
    flops_gpu = flops_replica / (tp_eff * par.pp)
    t_comp = flops_gpu / (hw.chip_flops * hw.mfu_ceiling) / power_speedup

    # ---- TP collectives (Megatron: 4 allreduce/layer fwd+bwd) -------------
    act_bytes_mb = par.microbatch_seqs * wl.seq_len * wl.d_model * wl.act_bytes
    vol_per_layer = 4 * 2 * act_bytes_mb * (tp_eff - 1) / tp_eff
    layers_local = wl.n_layers / par.pp
    t_tp = layers_local * m * vol_per_layer / hw.scaleup_bw / power_speedup
    t_tp_exposed = t_tp * (1.0 - tp_overlap)

    # ---- PP bubble ---------------------------------------------------------
    bubble = (par.pp - 1) / max(m, 1)
    t_pp = (t_comp + t_tp_exposed) * bubble

    # ---- DP gradient all-reduce -------------------------------------------
    grad_bytes_gpu = 2.0 * wl.n_params / (tp_eff * par.pp)
    # sync at the min TP degree: volume rises when any replica is reduced
    t_dp = 2.0 * grad_bytes_gpu * (par.dp - 1) / par.dp / hw.scaleout_bw
    t_dp_exposed = t_dp * (1.0 - dp_overlap)

    # ---- NTP reshard (§3.1): within scale-up domain, overlapped ------------
    t_reshard_exposed = 0.0
    if tp_reduced is not None and tp_reduced != par.tp:
        shard_bytes = 2.0 * wl.n_params / (par.tp * par.pp)
        reshard_bytes = shard_bytes * (1.0 - tp_reduced / par.tp) * 2  # pre+post
        t_reshard = reshard_bytes / hw.scaleup_bw
        if reshard_overlap is None:
            # Fig. 8: overlapped with the final backward; exposed part is
            # linear in comm:comp with a small slope — model 10% exposed
            t_reshard_exposed = 0.1 * t_reshard
        else:
            t_reshard_exposed = (1.0 - reshard_overlap) * t_reshard

    # ---- straggler gate (taxonomy §2.11): priced like the bubble — an
    # additive multiplier on the busy time (the slow domain stretches every
    # microbatch's compute and collectives; 0.0 exactly when healthy)
    t_straggle = (
        (t_comp + t_tp_exposed) * (slow_factor - 1.0)
        if slow_factor != 1.0 else 0.0
    )

    total = (t_comp + t_tp_exposed + t_pp + t_dp_exposed + t_reshard_exposed
             + t_straggle)
    return {
        "total": total,
        "compute": t_comp,
        "tp_exposed": t_tp_exposed,
        "pp_bubble": t_pp,
        "dp_exposed": t_dp_exposed,
        "reshard_exposed": t_reshard_exposed,
        "straggler_exposed": t_straggle,
        "microbatches": m,
        "per_gpu_tput": tokens_per_replica / total / tp_eff / par.pp,
    }


def staged_iteration_time(
    hw: Hardware,
    wl: Workload,
    par: Parallel,
    stage_tps,
    **kw,
) -> Dict[str, float]:
    """`iteration_time` under per-stage reduced TP degrees (nonuniform PP,
    DESIGN.md §2.6): 1F1B runs every microbatch through every stage, so the
    replica is gated by its SLOWEST stage — the breakdown is exactly
    ``iteration_time(tp_reduced=min(stage_tps))``. This is the analytic twin
    of the live runtime's per-stage ``rel_iter_time`` metric (max over
    stages of `policies.staged_rel_iter_times`)."""
    stage_tps = tuple(stage_tps)
    if len(stage_tps) != par.pp:
        raise ValueError(f"{len(stage_tps)} stage TPs for pp={par.pp}")
    if not all(1 <= t <= par.tp for t in stage_tps):
        raise ValueError(f"stage TPs {stage_tps} outside [1, {par.tp}]")
    tp_red = min(stage_tps)
    return iteration_time(
        hw, wl, par, tp_reduced=(None if tp_red == par.tp else tp_red), **kw
    )


def exposed_comm(sync_s: float, overlappable_compute_s: float) -> float:
    """Exposed gradient-sync time once overlap is on (DESIGN.md §2.10):
    the sync that does not fit inside the backward window stays on the
    critical path — ``max(0, sync − overlappable_compute)``. This is the
    identity the reference's `benchmarks/bench_hotpath.py` and
    `launch/telemetry_report.py` both use, so the measured and modeled
    decompositions cannot drift apart."""
    return max(0.0, float(sync_s) - float(overlappable_compute_s))


def overlap_iteration_time(
    hw: Hardware,
    wl: Workload,
    par: Parallel,
    *,
    overlappable_fraction: float = 0.7,
    collective_ratio: float = 1.0,
    **kw,
) -> Dict[str, float]:
    """Overlap-aware iteration time (DESIGN.md §2.10).

    `iteration_time`'s fixed dp_overlap/reshard heuristics model a generic
    well-tuned stack. The overlap engine makes those knobs explicit: start
    from a FULLY exposed sync (dp_overlap=0, reshard_overlap=0), then hide
    it behind the layer-chunked backward window

        window  = overlappable_fraction × (compute + tp_exposed + pp_bubble)
        exposed = exposed_comm(sync, window)

    ``collective_ratio`` scales the sync term by the bucketed/sequential
    launch-count ratio (`overlap.sync_collectives`) for launch-bound
    regimes — on real interconnects bandwidth dominates and 1.0 is right;
    on the CPU emulation the reference's bench_hotpath measures a
    near-linear collapse. ``kw`` forwards to `iteration_time` (tp_reduced, local_batch_scale,
    power_speedup, tp_overlap); dp_overlap/reshard_overlap are owned here.

    Returns the `iteration_time` dict plus ``sync`` (full sync time),
    ``overlap_window`` and ``exposed_comm``; ``total``/``per_gpu_tput`` are
    recomputed with the overlapped sync. ``dp_exposed``/``reshard_exposed``
    keep their pre-overlap (fully exposed) values so the sync composition
    stays visible."""
    if not 0.0 <= overlappable_fraction <= 1.0:
        raise ValueError(
            f"overlappable_fraction {overlappable_fraction} outside [0, 1]")
    if collective_ratio <= 0.0:
        raise ValueError(f"collective_ratio {collective_ratio} <= 0")
    base = iteration_time(
        hw, wl, par, dp_overlap=0.0, reshard_overlap=0.0, **kw
    )
    sync = (base["dp_exposed"] + base["reshard_exposed"]) * collective_ratio
    window = overlappable_fraction * (
        base["compute"] + base["tp_exposed"] + base["pp_bubble"]
    )
    exposed = exposed_comm(sync, window)
    total = (base["compute"] + base["tp_exposed"] + base["pp_bubble"]
             + base["straggler_exposed"] + exposed)
    tokens_per_replica = (
        wl.minibatch_tokens / par.dp * kw.get("local_batch_scale", 1.0)
    )
    tp_eff = kw.get("tp_reduced") or par.tp
    out = dict(base)
    out.update(
        total=total,
        sync=sync,
        overlap_window=window,
        exposed_comm=exposed,
        per_gpu_tput=tokens_per_replica / total / tp_eff / par.pp,
    )
    return out


def best_config(
    hw: Hardware, wl: Workload, n_gpus: int, *, tp_limit: Optional[int] = None,
    min_pp: int = 1,
) -> Dict:
    """Exhaustive hybrid-parallel search (paper Fig. 2b): best per-GPU
    throughput subject to a TP-degree cap (TP ≤ scale-up domain). Candidate
    PP degrees come from the runtime's supported ladder
    (`configs.shapes.candidate_pp` — every stage must own a layer), so the
    search space and the executable stage-partitioned step cannot drift
    apart."""
    from repro_torch.configs.shapes import candidate_pp

    best = None
    tp_max = min(tp_limit or hw.domain_size, hw.domain_size)
    tp = 1
    while tp <= tp_max:
        for pp in candidate_pp(wl.n_layers):
            if pp < min_pp or n_gpus % (tp * pp):
                continue
            dp = n_gpus // (tp * pp)
            if dp < 1:
                continue
            # memory feasibility: params+grads+opt (16 bytes/param ZeRO over
            # dp) + activations must fit 180GB-class HBM per the paper's B200
            bytes_model = wl.n_params * (2 + 2) / (tp * pp) + wl.n_params * 12 / (
                tp * pp * dp
            )
            if bytes_model > 150e9:
                continue
            if wl.minibatch_tokens / dp < wl.seq_len:  # < 1 seq per replica
                continue
            r = iteration_time(hw, wl, Parallel(tp=tp, pp=pp, dp=dp))
            cand = {"tp": tp, "pp": pp, "dp": dp, **r}
            if best is None or cand["per_gpu_tput"] > best["per_gpu_tput"]:
                best = cand
        tp *= 2
    return best
