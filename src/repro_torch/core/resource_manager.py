"""Packing of partially failed scale-up domains into DP replicas (port of
`repro/core/resource_manager.py`; pure numpy, its assignments must stay
bit-identical to the reference's)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class ReplicaAssignment:
    domain_ids: np.ndarray      # (domains_per_replica,)
    failed: np.ndarray          # failed GPUs per domain
    tp: int                     # operating TP degree (min healthy in replica)
    donated_gpus: int           # healthy GPUs idled by the min-TP constraint


def apply_spares(failed_counts: np.ndarray, n_spare_domains: int) -> np.ndarray:
    """Replace the most-failed domains with spares (clean)."""
    out = failed_counts.copy()
    if n_spare_domains <= 0:
        return out
    worst = np.argsort(-out)[:n_spare_domains]
    out[worst[out[worst] > 0]] = 0
    return out


def pack_replicas(
    failed_counts: Sequence[int], domain_size: int, domains_per_replica: int
) -> List[ReplicaAssignment]:
    """Sort domains most-failed-first and group consecutively: failures are
    concentrated into the lowest-rank replicas (paper: "unhealthy racks are
    packed together by being placed in the lowest ranks")."""
    failed = np.asarray(failed_counts)
    order = np.argsort(-failed, kind="stable")
    n_rep = len(failed) // domains_per_replica
    out = []
    for r in range(n_rep):
        ids = order[r * domains_per_replica: (r + 1) * domains_per_replica]
        f = failed[ids]
        tp = int(domain_size - f.max())
        donated = (int(((domain_size - f) - tp).clip(min=0).sum()) if tp > 0
                   else int((domain_size - f).sum()))
        out.append(ReplicaAssignment(ids, f, max(tp, 0), donated))
    return out


def packing_stats(assignments: List[ReplicaAssignment],
                  domain_size: int) -> dict:
    """Replicas, those below full TP, those at TP 0, and the healthy GPUs
    the min-TP constraint idles, over ``assignments``."""
    affected = [a for a in assignments if a.tp < domain_size]
    return {
        "replicas": len(assignments),
        "affected_replicas": len(affected),
        "dead_replicas": sum(1 for a in assignments if a.tp == 0),
        "donated_gpus": sum(a.donated_gpus for a in assignments),
    }
