"""NTP-mode dry-run: the nonuniform-TP train step of the process path at
the production mesh (data 16 × model 16) with a degraded replica, its
reshard collectives counted — port of `repro/launch/dryrun_ntp.py`, the
paper's Fig. 9 overhead breakdown derived from the step's own
collectives.

The reference lowers one SPMD program for every device. The port's ranks
run different programs (a degraded replica's ranks reshard, a healthy
replica's do not), so each is dry-run as its own process of the fake
mesh (`launch.mesh.make_production_mesh`, ``meta`` tensors): rank 0 of a
healthy replica and every live rank of the degraded one, each through
`core.ntp_train.make_rank_train_step` (the sequential per-leaf sync, SGD)
on its packed params built from shapes (`canonical_like` →
`pack_rank_params`, nothing drawn). The report keeps the reference's
keys, each the maximum over the ranks run, with every rank's own under
``ranks``. Seconds are at the card's peaks (`launch.dryrun`): f32 FLOPs
(the prototype trains in f32) and NVLink bytes each way.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_ntp --mesh 2x4 --degraded-tp 3 --d-model 512 --seq 128 --out /tmp/ntp_dryrun.json
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core import ntp_train as nt
from repro_torch.launch import op_analysis
from repro_torch.launch.dryrun import LINK_BW, PEAK_FLOPS_F32
from repro_torch.launch.mesh import close_fake_mesh, make_production_mesh
from repro_torch.optim import sgd
from repro_torch.runtime import ClusterHealth, Mode, plan_from_health

_NONE = {"count": 0, "moved_bytes": 0}


def build_cfg(d_model: int = 6144) -> nt.NTPModelConfig:
    # the paper's §5.1 prototype dims (hidden 6144, head dim 128, ffn 4x)
    return nt.NTPModelConfig(
        d_model=d_model,
        n_kv_groups=16, q_per_kv=3 if d_model == 6144 else 6, head_dim=128,
        d_ff=4 * d_model,
        unit_rows=128,
        n_layers=2, vocab=32000,
    )


def rank_step(cfg, fplan, mode, replica: int, rank: int, *,
              local_batch: int, seq: int, mesh_shape):
    """`op_analysis.analyze_step` of one meta step of process (``replica``,
    ``rank``) under ``fplan``."""
    mesh = make_production_mesh(replica=replica, rank=rank,
                                shape=mesh_shape)
    try:
        optimizer = sgd(1e-2)  # memory-neutral: dryrun reports temp bytes
        step = nt.make_rank_train_step(cfg, fplan, mesh, mode=mode,
                                       local_batch=local_batch,
                                       optimizer=optimizer)
        params = nt.pack_rank_params(cfg, nt.canonical_like(cfg), fplan,
                                     replica, rank)
        tokens = torch.empty((mesh_shape[0] * local_batch, seq + 1),
                             dtype=torch.int32, device="meta")
        return op_analysis.analyze_step(
            step, params, optimizer.init(params), tokens,
            group_sizes=op_analysis.group_sizes(mesh))
    finally:
        close_fake_mesh()


def _fields(hlo):
    a2a = hlo["collectives"].get("all-to-all", _NONE)
    ar = hlo["collectives"].get("all-reduce", _NONE)
    return {
        "flops_per_device": hlo["flops"],
        "compute_s": hlo["flops"] / PEAK_FLOPS_F32,
        "all_to_all": a2a,
        "all_reduce": ar,
        "reshard_s": a2a["moved_bytes"] / LINK_BW,
        "allreduce_s": ar["moved_bytes"] / LINK_BW,
        "collectives": hlo["collectives"],
        "memory_temp_bytes": hlo["saved_bytes"],
    }


def run(replica_tp, *, d_model: int = 6144, local_batch: int = 1,
        seq: int = 2048, mesh_shape=(16, 16)):
    """The reference's record of one plan, each field the maximum over the
    ranks run (rank 0 of the first healthy replica, every live rank of
    each degraded one), those ranks' own records under ``ranks``."""
    cfg = build_cfg(d_model)
    # event/health bridge: replica_tp -> per-domain failures -> packed plan
    health = ClusterHealth(
        domain_size=mesh_shape[1],
        failed=tuple(mesh_shape[1] - t for t in replica_tp),
    )
    fplan = plan_from_health(health)
    mode = Mode.UNIFORM if fplan.healthy else Mode.NTP
    healthy = [d for d, t in enumerate(fplan.replica_tp) if t == fplan.n1]
    at = [(healthy[0], 0)] if healthy else []
    at += [(d, r) for d, t in enumerate(fplan.replica_tp) if t < fplan.n1
           for r in range(t)]
    ranks = []
    for d, r in at:
        f = _fields(rank_step(cfg, fplan, mode, d, r,
                              local_batch=local_batch, seq=seq,
                              mesh_shape=mesh_shape))
        ranks.append(dict(f, replica=d, rank=r))

    def worst(key):
        return max((x[key] for x in ranks), key=lambda v: v["moved_bytes"])

    out = {"replica_tp": list(fplan.replica_tp), "mode": mode.value}
    for key in ("flops_per_device", "compute_s", "reshard_s", "allreduce_s",
                "memory_temp_bytes"):
        out[key] = max(x[key] for x in ranks)
    out["all_to_all"], out["all_reduce"] = worst("all_to_all"), \
        worst("all_reduce")
    out["collectives"] = max((x["collectives"] for x in ranks),
                             key=lambda c: sum(v["moved_bytes"]
                                               for v in c.values()))
    out["ranks"] = ranks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--degraded-tp", type=int, default=14)
    ap.add_argument("--d-model", type=int, default=6144)
    ap.add_argument("--mesh", default="16x16",
                    help="data x model, e.g. 4x8")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--local-batch", type=int, default=1)
    ap.add_argument("--out", default="results/ntp_dryrun.json")
    args = ap.parse_args(argv)

    md, mm = (int(t) for t in args.mesh.split("x"))
    kw = dict(d_model=args.d_model, mesh_shape=(md, mm), seq=args.seq,
              local_batch=args.local_batch)
    healthy = run([mm] * md, **kw)
    degraded = run([args.degraded_tp] + [mm] * (md - 1), **kw)
    delta_ar = degraded["allreduce_s"] - healthy["allreduce_s"]
    report = {
        "healthy": healthy,
        "degraded": degraded,
        "overhead": {
            "reshard_s": degraded["reshard_s"],
            "allreduce_increase_s": delta_ar,
            "reshard_vs_compute": degraded["reshard_s"] / degraded["compute_s"],
            "note": "paper Fig. 9: reshard overlaps backward; all-reduce "
                    "volume grows ∝ TP reduction; both <1% e2e",
        },
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["overhead"], indent=1))
    print(f"healthy: ar={healthy['allreduce_s']*1e3:.1f}ms a2a={healthy['reshard_s']*1e3:.2f}ms "
          f"compute={healthy['compute_s']*1e3:.1f}ms")
    print(f"degraded: ar={degraded['allreduce_s']*1e3:.1f}ms a2a={degraded['reshard_s']*1e3:.2f}ms "
          f"compute={degraded['compute_s']*1e3:.1f}ms")


if __name__ == "__main__":
    main()
