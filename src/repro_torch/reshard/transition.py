"""Direct packed→packed fail/repair transitions for NTP training (port of
`repro/reshard/transition.py` at pp=1): re-express packed param/optimizer
trees under a new `FailurePlan` without a dense round trip.

Each replica's comp→comp' `TransitionPlan` comes from the planner and is
applied directly on the packed buffers where they lie (on the card in a
run, no host round trip): stays are rank-local slot renames, and only units
whose rank changes travel, fused into ONE message per (replica, src, dst)
across EVERY unit leaf of every tree handed in (params and both AdamW
moments ride the same messages). The `TransferStats` ledger records exactly
what moved and is bit-identical to the reference's on the same trees.
`transition_staged_trees` does the same stage by stage for a pipeline-
parallel job: each stage's layers move under that stage's own plans, so a
stage-local event moves nothing of any other stage.
`transition_rank_trees` is the per-rank form on a `launch.mesh.RankMesh`:
each process moves its own slots, and the messages of every unit leaf to
one peer travel in one `all_to_all_units` over the replica's model group.
Under `StagedPlan`s it is stage-local: only the stages whose plan changed
move, each over its own model group; on a staged mesh every process of an
untouched stage keeps its trees and sends nothing.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.configs.shapes import stage_boundaries
from repro_torch.core import collectives as C
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
    groups = _unit_groups(cfg, trees)

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


def _unit_groups(cfg, trees):
    """{k: [(tree index, path, leaf), ...]} of every unit leaf of
    ``trees``, in flatten order (the order every rank shares)."""
    specs = ntp_unit_specs(cfg)
    groups: Dict[int, List[Tuple[int, tr.Path, torch.Tensor]]] = {}
    for ti, t in enumerate(trees):
        for path, leaf in tr.leaves_with_path(t):
            spec = specs.get(tr.leaf_key(path))
            if spec is not None:
                groups.setdefault(spec.k, []).append((ti, path, leaf))
    return groups


def _rank_ledger(groups, plans, n1: int, tag: Tuple[int, ...] = ()
                 ) -> TransferStats:
    """The whole mesh's `TransferStats` of a transition, computed from the
    plans and one rank's leaf shapes (every rank's buffers share them):
    `apply_plan`'s accounting, replica by replica, pairs keyed
    ``tag + (replica, src, dst)``."""
    stats = TransferStats()
    for k, members in groups.items():
        leaves = [leaf for _, _, leaf in members]
        for d, p in enumerate(plans[k]):
            stats.stayed_units += p.n_stay * len(leaves)
            stats.dense_bytes += sum(n1 * x.numel() * x.element_size()
                                     for x in leaves)
            for s, t in p.pairs:
                n_units = int(((p.move_src_rank == s)
                               & (p.move_dst_rank == t)).sum())
                key = tag + (d, s, t)
                if key not in stats.per_pair:
                    stats.messages += 1
                stats.moved_units += n_units * len(leaves)
                stats.per_pair[key] = stats.per_pair.get(key, 0) + n_units
                stats.bytes_moved += sum(n_units * x[0].numel()
                                         * x.element_size() for x in leaves)
    return stats


def transition_rank_trees(
    cfg, trees: Sequence[Dict], old, new, mesh,
) -> Tuple[List[Dict], TransferStats]:
    """`transition_trees` on one (replica, rank) process (a collective of
    every process): its unit leaves (src_buf, *unit) become (dst_buf,
    *unit) under ``new``. Stays are rank-local slot renames; the movers of
    every unit leaf of every tree to one peer form one message, all of them
    sent by one `all_to_all_units` over the replica's model group (one per
    dtype when the trees mix dtypes), zero-length where nothing moves.
    Replicated leaves pass through as they are (not copied: the caller
    drops its old trees). Returns the trees and the whole mesh's
    `TransferStats`, equal to the emulated transition's.

    Under `StagedPlan`s (`transition_staged_trees`' contract) each stage
    whose plan changed moves its layers under its own plans, ledger keys
    tagged by stage; an unchanged stage passes through. On a 2-D mesh the
    process holds every stage and moves each changed one in turn; on a
    staged mesh it moves only its own stage, if that changed, and every
    process computes the whole mesh's ledger (another stage's from the
    shapes alone)."""
    if isinstance(old, nu.StagedPlan) or isinstance(new, nu.StagedPlan):
        return _transition_rank_staged(cfg, trees, nu.as_staged(old),
                                       nu.as_staged(new), mesh)
    return _transition_rank(cfg, trees, old, new, mesh)


def _transition_rank_staged(cfg, trees, old: nu.StagedPlan,
                            new: nu.StagedPlan, mesh):
    if old.pp != new.pp or old.n1 != new.n1 or old.d != new.d:
        raise ValueError(f"staged plans of different jobs: {old} -> {new}")
    mine = mesh.stage if getattr(mesh, "pp", 1) > 1 else None
    bounds = stage_boundaries(cfg.n_layers, old.pp)
    stats = TransferStats()
    outs = [dict(t, layers=list(t["layers"])) for t in trees]
    for s in range(old.pp):
        if new.stages[s] == old.stages[s]:
            continue
        lo, hi = bounds[s], bounds[s + 1]
        subs = [{"layers": t["layers"][lo:hi]} for t in trees]
        if mine is None or mine == s:
            moved, st = _transition_rank(cfg, subs, old.stages[s],
                                         new.stages[s], mesh, tag=(s,))
            for o, m in zip(outs, moved):
                o["layers"][lo:hi] = m["layers"]
        else:
            st = _rank_ledger(*_stage_groups(cfg, trees, subs, old.stages[s],
                                             new.stages[s]),
                              mesh.n_model, tag=(s,))
        stats.merge(st)
    return outs, stats


def _stage_groups(cfg, trees, subs, old: nu.FailurePlan,
                  new: nu.FailurePlan):
    """(groups, plans) of another stage's layers ``subs`` (``{}`` on this
    process), as `_rank_ledger` reads them: ``meta`` leaves of that stage's
    buffer width, each tree's dtype and unit shapes taken from this
    process's own layers."""
    specs = ntp_unit_specs(cfg)
    plans = {spec.k: replica_transition_plans(spec.k, old, new)
             for spec in set(specs.values())}
    groups: Dict[int, List] = {}
    for ti, (t, sub) in enumerate(zip(trees, subs)):
        like = next(lp for lp in t["layers"] if lp)
        for li in range(len(sub["layers"])):
            for key in sorted(like):
                spec = specs.get(key)
                if spec is None:
                    continue
                w = like[key]
                buf = plans[spec.k][0].src_buf
                groups.setdefault(spec.k, []).append((ti, ("layers", li, key),
                    torch.empty((buf,) + tuple(w.shape[1:]), dtype=w.dtype,
                                device="meta")))
    return groups, plans


def _transition_rank(cfg, trees, old: nu.FailurePlan, new: nu.FailurePlan,
                     mesh, tag: Tuple[int, ...] = ()):
    """`transition_rank_trees` under plain plans."""
    if old.n1 != mesh.n_model or old.d != mesh.n_data:
        raise ValueError(f"plan {old} does not fit mesh {tuple(mesh)}")
    groups = _unit_groups(cfg, trees)
    plans = {k: replica_transition_plans(k, old, new) for k in groups}
    stats = _rank_ledger(groups, plans, mesh.n_model, tag)
    d, r, n = mesh.replica, mesh.rank, mesh.n_model
    outs = [tr.tree_map(lambda x: x, t) for t in trees]
    with torch.no_grad():
        fresh = {}
        for k, members in groups.items():
            p = plans[k][d]
            stay = p.stay_rank == r
            for ti, path, leaf in members:
                if leaf.shape[0] != p.src_buf:
                    raise ValueError(f"leaf {tuple(leaf.shape)} is not "
                                     f"packed at buf={p.src_buf}")
                o = leaf.new_zeros((p.dst_buf,) + tuple(leaf.shape[1:]))
                o[_rows(p.stay_dst_slot[stay], o)] = \
                    leaf[_rows(p.stay_src_slot[stay], o)]
                fresh[(ti, path)] = o
        for dtype in sorted({m[2].dtype for ms in groups.values()
                             for m in ms}, key=str):
            _exchange(groups, plans, fresh, dtype, d, r, n, mesh.model)
        for (ti, path), o in fresh.items():
            tr.set_path(outs[ti], path, o)
    return outs, stats


def _rows(slots, like) -> torch.Tensor:
    return torch.as_tensor(slots, device=like.device).long()


def _moves(p, src: int, dst: int):
    sel = (p.move_src_rank == src) & (p.move_dst_rank == dst)
    return p.move_src_slot[sel], p.move_dst_slot[sel]


def _exchange(groups, plans, fresh, dtype, d, r, n, group) -> None:
    """One all-to-all of every ``dtype`` unit leaf's movers: rank r's
    message to peer j holds, family by family and leaf by leaf, the rows of
    the units moving r -> j (flattened); it scatters what it receives from
    each peer into ``fresh``."""
    members = {k: [m for m in ms if m[2].dtype == dtype]
               for k, ms in groups.items()}
    send, send_counts, recv_counts = [], [], []
    for j in range(n):               # a plan never moves a unit to itself
        sent = received = 0
        for k, ms in members.items():
            src_slots = _moves(plans[k][d], r, j)[0]
            n_in = len(_moves(plans[k][d], j, r)[1])
            for _, _, leaf in ms:
                e = leaf[0].numel()
                if len(src_slots):
                    send.append(leaf.index_select(
                        0, _rows(src_slots, leaf)).reshape(-1))
                sent += len(src_slots) * e
                received += n_in * e
        send_counts.append(sent)
        recv_counts.append(received)
    like = next(m[2] for ms in members.values() for m in ms)
    flat = torch.cat(send) if send else like.new_zeros((0,))
    recv = C.all_to_all_units(flat, send_counts, recv_counts, group)
    off = 0
    for j in range(n):
        for k, ms in members.items():
            dst_slots = _moves(plans[k][d], j, r)[1]
            for ti, path, leaf in ms:
                size = len(dst_slots) * leaf[0].numel()
                if size:
                    o = fresh[(ti, path)]
                    o[_rows(dst_slots, o)] = recv[off:off + size].reshape(
                        (len(dst_slots),) + tuple(leaf.shape[1:]))
                off += size


def transition_params(
    cfg, packed: Dict, old: nu.FailurePlan, new: nu.FailurePlan
) -> Tuple[Dict, TransferStats]:
    """Single-tree convenience wrapper over `transition_trees`."""
    (tree,), stats = transition_trees(cfg, [packed], old, new)
    return tree, stats


def transition_staged_trees(
    cfg,
    trees: Sequence[Dict],
    old: nu.StagedPlan,
    new: nu.StagedPlan,
    *,
    copy_unchanged: bool = True,
) -> Tuple[List[Dict], TransferStats]:
    """Stage-local packed→packed transition of stage-partitioned trees: each
    pipeline stage's layer slice moves under its OWN (old, new) stage-plan
    pair through `transition_trees` (ledger keys tagged by stage, so sends
    of different device groups never fuse), so a failure in stage s moves
    only stage-s units. Top-level replicated leaves (embed, head,
    final_norm) never move. Returns the transitioned trees and the merged
    `TransferStats`.

    ``copy_unchanged``: untouched stages and the replicated leaves are
    copied into fresh tensors by default, so no result aliases a tree the
    caller still holds (the optimizers update in place). A caller that drops
    its old trees (the session) passes False: untouched stages then pass
    through with zero bytes and no copy, each tensor still held by exactly
    one tree."""
    if old.pp != new.pp or old.n1 != new.n1 or old.d != new.d:
        raise ValueError(f"staged plans of different jobs: {old} -> {new}")
    bounds = stage_boundaries(cfg.n_layers, old.pp)
    stats = TransferStats()
    keep = (lambda t: t) if not copy_unchanged else torch.clone
    outs = [{k: tr.tree_map(keep, v) for k, v in t.items() if k != "layers"}
            for t in trees]
    out_layers = [[None] * cfg.n_layers for _ in trees]
    for s in range(old.pp):
        lo, hi = bounds[s], bounds[s + 1]
        if new.stages[s] == old.stages[s]:
            for ti, t in enumerate(trees):
                out_layers[ti][lo:hi] = [tr.tree_map(keep, lp)
                                         for lp in t["layers"][lo:hi]]
            continue
        subs = [{"layers": list(t["layers"][lo:hi])} for t in trees]
        moved, st = transition_trees(cfg, subs, old.stages[s], new.stages[s],
                                     tag=(s,))
        stats.merge(st)
        for ti, m in enumerate(moved):
            out_layers[ti][lo:hi] = m["layers"]
    for ti, o in enumerate(outs):
        o["layers"] = out_layers[ti]
    return outs, stats


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
