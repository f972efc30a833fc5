"""The Algorithm-1 planner (port of `repro/reshard/planner.py`): layout
keys, padded all-to-all tables and compiled `TransitionPlan`s, LRU-cached
over `core.shard_mapping`. Serving addresses a replica at TP degree ``n2``
as the sync layout ``("sync", k, n1, n2)``: k units contiguously balanced
over the first ``n2`` of ``n1`` rank slots. Pure numpy; its tables must
stay bit-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from repro_torch.core import shard_mapping as sm

LayoutKey = Tuple  # ("sync", k, n1, n2) | ("comp", k, n1, nr, n2)


def sync_key(k: int, n1: int, n2: int) -> LayoutKey:
    return ("sync", k, n1, n2)


def comp_key(k: int, n1: int, nr: int, n2: int) -> LayoutKey:
    return ("comp", k, n1, nr, n2)


@lru_cache(maxsize=None)
def layout(key: LayoutKey) -> sm.Layout:
    """Resolve a layout key to its `shard_mapping.Layout` (cached)."""
    kind = key[0]
    if kind == "sync":
        _, k, n1, n2 = key
        assert 1 <= n2 <= n1, key
        return sm.make_layout(sm.sync_assignment(k, n2), n1)
    if kind == "comp":
        _, k, n1, nr, n2 = key
        assert 1 <= n2 <= nr <= n1, key
        return sm.make_layout(sm.comp_assignment(k, nr, n2), n1)
    raise ValueError(f"unknown layout key kind {kind!r} in {key}")


@lru_cache(maxsize=None)
def tables(src: LayoutKey, dst: LayoutKey, buf: int) -> sm.ReshardTables:
    """Padded all-to-all tables for one src→dst layout change (cached)."""
    return sm.reshard_tables(layout(src), layout(dst), buf)


@dataclass(frozen=True)
class TransitionPlan:
    """A compiled src→dst layout change for one unit family.

    ``tables`` drive the padded-message collective/kernel route at the
    common ``buf``; the flat index arrays drive the direct host route
    (the reference's `reshard/transition.py`): stays are rank-local slot renames, moves
    are grouped into one bucket per (src_rank, dst_rank) pair. ``transfer``
    is the unit `transfer_matrix` — its off-diagonal sum is the ONLY
    traffic a transition is allowed to generate.
    """

    k: int
    n: int
    src_buf: int                 # slots per rank in the source packing
    dst_buf: int                 # slots per rank in the destination packing
    buf: int                     # common buffer the message tables assume
    tables: sm.ReshardTables
    # stays (src_rank == dst_rank), unit-id order
    stay_rank: np.ndarray        # (n_stay,)
    stay_src_slot: np.ndarray
    stay_dst_slot: np.ndarray
    # moves (src_rank != dst_rank), unit-id order
    move_src_rank: np.ndarray    # (n_move,)
    move_src_slot: np.ndarray
    move_dst_rank: np.ndarray
    move_dst_slot: np.ndarray
    transfer: np.ndarray         # (n, n) units from src rank -> dst rank

    @property
    def n_moved(self) -> int:
        """Units that change ranks — the network traffic of the move."""
        return int(self.transfer.sum() - np.trace(self.transfer))

    @property
    def n_stay(self) -> int:
        return int(np.trace(self.transfer))

    @property
    def pairs(self) -> list:
        """Non-empty (src_rank, dst_rank) message pairs, src != dst — the
        transition issues exactly ONE fused send per pair."""
        off = self.transfer - np.diag(np.diag(self.transfer))
        return [tuple(p) for p in np.argwhere(off > 0)]

    @property
    def identity(self) -> bool:
        return self.n_moved == 0 and self.src_buf == self.dst_buf and bool(
            np.array_equal(self.stay_src_slot, self.stay_dst_slot)
        )


@lru_cache(maxsize=None)
def transition_plan(
    src: LayoutKey,
    dst: LayoutKey,
    src_buf: int | None = None,
    dst_buf: int | None = None,
) -> TransitionPlan:
    """Compile one src→dst layout change (cached — the LRU plan cache)."""
    ls, ld = layout(src), layout(dst)
    assert ls.k == ld.k and ls.n == ld.n, (src, dst)
    sb = ls.max_count if src_buf is None else int(src_buf)
    db = ld.max_count if dst_buf is None else int(dst_buf)
    assert sb >= ls.max_count and db >= ld.max_count, (sb, db, src, dst)
    buf = max(sb, db)

    moved = ls.assignment != ld.assignment
    stay = ~moved
    return TransitionPlan(
        k=ls.k,
        n=ls.n,
        src_buf=sb,
        dst_buf=db,
        buf=buf,
        tables=tables(src, dst, buf),
        stay_rank=ls.assignment[stay].copy(),
        stay_src_slot=ls.local_slot[stay].copy(),
        stay_dst_slot=ld.local_slot[stay].copy(),
        move_src_rank=ls.assignment[moved].copy(),
        move_src_slot=ls.local_slot[moved].copy(),
        move_dst_rank=ld.assignment[moved].copy(),
        move_dst_slot=ld.local_slot[moved].copy(),
        transfer=sm.transfer_matrix(ls, ld),
    )
