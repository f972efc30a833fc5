"""Direct packed→packed fail/repair transitions for NTP training (port of
`repro/reshard/transition.py` at pp=1): re-express packed param/optimizer
trees under a new `FailurePlan` without a dense round trip.

Each replica's comp→comp' `TransitionPlan` comes from the planner and is
applied directly on the packed buffers where they lie (on the card in a
run, no host round trip): stays are rank-local slot renames, and only units
whose rank changes travel, fused into ONE message per (replica, src, dst)
across EVERY unit leaf of every tree handed in (params and both AdamW
moments ride the same messages). The `TransferStats` ledger records exactly
what moved and is bit-identical to the reference's on the same trees. The
staged (pp>1) variant waits for the port's pp>1 slice.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.core import nonuniform as nu
from repro_torch.reshard import planner
from repro_torch.reshard.twin import TransferStats, apply_plan
from repro_torch.reshard.units import ntp_unit_specs


def replica_transition_plans(
    k: int, old: nu.FailurePlan, new: nu.FailurePlan
) -> List[planner.TransitionPlan]:
    """Per-replica comp(old)→comp(new) plans for one k-unit weight family,
    at the packed buffer widths of the two whole-mesh `WeightPlan`s."""
    if old.n1 != new.n1 or old.d != new.d:
        raise ValueError(f"plans of different meshes: {old} -> {new}")
    old_wp, new_wp = nu.weight_plan(k, old), nu.weight_plan(k, new)
    return [
        planner.transition_plan(
            planner.comp_key(k, old.n1, old.replica_tp[d], old.n_sync),
            planner.comp_key(k, new.n1, new.replica_tp[d], new.n_sync),
            old_wp.buf,
            new_wp.buf,
        )
        for d in range(old.d)
    ]


def transition_trees(
    cfg,
    trees: Sequence[Dict],
    old: nu.FailurePlan,
    new: nu.FailurePlan,
    *,
    tag: Tuple[int, ...] = (),
) -> Tuple[List[Dict], TransferStats]:
    """Re-express packed trees (params, AdamW m/v, …) under ``new``.

    Every unit leaf across ALL ``trees`` joins the same per-(replica, src,
    dst) messages. Replicated leaves are copied through untouched (fresh
    buffers, as the reference's). Returns the transitioned trees and the
    fused `TransferStats`."""
    specs = ntp_unit_specs(cfg)
    stats = TransferStats()
    if new == old:
        return [tr.tree_map(torch.clone, t) for t in trees], stats

    plans = {s.k: replica_transition_plans(s.k, old, new)
             for s in set(specs.values())}
    n1, d_axis = old.n1, old.d

    groups: Dict[int, List[Tuple[int, tr.Path, torch.Tensor]]] = {}
    for ti, t in enumerate(trees):
        for path, leaf in tr.leaves_with_path(t):
            spec = specs.get(tr.leaf_key(path))
            if spec is not None:
                groups.setdefault(spec.k, []).append((ti, path, leaf))

    outs = [tr.tree_map(lambda x: None, t) for t in trees]
    with torch.no_grad():
        for k, members in groups.items():
            k_plans = plans[k]
            src_buf, dst_buf = k_plans[0].src_buf, k_plans[0].dst_buf
            views, new_bufs = [], []
            for _, _, arr in members:
                if arr.shape[1] != n1 * src_buf:
                    raise ValueError(
                        f"leaf {tuple(arr.shape)} is not packed at "
                        f"n1={n1} x buf={src_buf}")
                views.append(arr.reshape(d_axis, n1, src_buf, -1))
                new_bufs.append(arr.new_zeros(
                    (d_axis, n1 * dst_buf) + tuple(arr.shape[2:])))
            for d in range(d_axis):
                apply_plan(
                    [v[d] for v in views], k_plans[d], stats=stats,
                    pair_tag=tag + (d,),
                    outs=[o[d].view(n1, dst_buf, -1) for o in new_bufs],
                )
            for (ti, path, _), o in zip(members, new_bufs):
                tr.set_path(outs[ti], path, o)
        for ti, t in enumerate(trees):
            for path, leaf in tr.leaves_with_path(t):
                if tr.leaf_key(path) not in specs:
                    tr.set_path(outs[ti], path, leaf.clone())
    return outs, stats


def transition_params(
    cfg, packed: Dict, old: nu.FailurePlan, new: nu.FailurePlan
) -> Tuple[Dict, TransferStats]:
    """Single-tree convenience wrapper over `transition_trees`."""
    (tree,), stats = transition_trees(cfg, [packed], old, new)
    return tree, stats


def expected_transfer(
    cfg, old: nu.FailurePlan, new: nu.FailurePlan
) -> Dict[str, np.ndarray]:
    """Per-family (n, n) unit transfer matrices summed over replicas — the
    ground truth `transition_trees`' accounting must reproduce."""
    out: Dict[str, np.ndarray] = {}
    for name, spec in ntp_unit_specs(cfg).items():
        mats = [p.transfer for p in replica_transition_plans(spec.k, old, new)]
        out[name] = np.sum(mats, axis=0)
    return out
