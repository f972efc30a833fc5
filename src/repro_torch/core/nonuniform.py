"""Nonuniform TP layouts for a whole (data=D, model=n1) job (port of
`repro/core/nonuniform.py`): per-replica health → per-weight stacked reshard
tables, plus packing between canonical weights and the padded per-rank unit
buffers.

Every rank owns a uniform ``(buf, unit, ...)`` buffer; a replica degraded to
n_r active ranks holds all k units on its first n_r ranks (its failed ranks
hold zeros — algebraically inert for Megatron-TP matmuls). ``buf`` is the
ceil-max over every replica's layouts, so one program serves the whole
nonuniform job. Pure numpy; plans and tables must stay bit-identical to the
reference's. The port emulates the mesh on one device, so a packed buffer
``(D, n1*buf, *unit)`` is one tensor holding every (replica, rank) buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from repro_torch.core import shard_mapping as sm


@dataclass(frozen=True)
class FailurePlan:
    """Static health of one training job on a (data=D, model=N1) mesh.

    replica_tp[d] = number of still-functional ranks in replica d's scale-up
    domain (the resource manager packs failures into low replica ids).
    """

    n1: int
    replica_tp: Tuple[int, ...]

    def __post_init__(self):
        if not all(1 <= t <= self.n1 for t in self.replica_tp):
            raise ValueError(
                f"replica_tp {self.replica_tp} outside [1, n1={self.n1}]")

    @property
    def d(self) -> int:
        return len(self.replica_tp)

    @property
    def n_sync(self) -> int:
        """Sync TP degree — the paper syncs at the minimum degree."""
        return min(self.replica_tp)

    @property
    def healthy(self) -> bool:
        return all(t == self.n1 for t in self.replica_tp)

    def local_batch_fraction(self, base_local_batch: int) -> np.ndarray:
        """Paper §3.1: degraded replicas reduce local batch ∝ active ranks
        (floor to whole samples)."""
        return np.array(
            [
                max(1, int(np.floor(base_local_batch * t / self.n1)))
                for t in self.replica_tp
            ]
        )


@dataclass(frozen=True)
class StagedPlan:
    """Per-(replica, stage) health of a DP×PP×TP job. The port trains at
    pp=1 only, so this is kept as far as the sync body needs it: a pp=1 job
    is exactly ``StagedPlan((plan,))`` and degenerates to the plain
    `FailurePlan` path everywhere."""

    stages: Tuple[FailurePlan, ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError("a StagedPlan needs at least one stage")
        n1, d = self.stages[0].n1, self.stages[0].d
        if not all(p.n1 == n1 and p.d == d for p in self.stages):
            raise ValueError(f"stages disagree on the mesh: {self.stages}")

    @property
    def pp(self) -> int:
        return len(self.stages)


def as_staged(plan) -> StagedPlan:
    """Coerce a `FailurePlan` (pp=1) or `StagedPlan` to the staged view."""
    if isinstance(plan, StagedPlan):
        return plan
    return StagedPlan((plan,))


@dataclass(frozen=True)
class StackedTables:
    """Per-replica reshard tables stacked over the data axis (numpy), padded
    to one common ``s_max``; `replica` hands one replica's tables to the
    rank-buffer route (`reshard.engine.reshard_ranks`)."""

    send_idx: np.ndarray  # (D, n, n, s_max) int32
    recv_idx: np.ndarray  # (D, n, n, s_max) int32
    stay_idx: np.ndarray  # (D, n, U) int32
    buf: int
    s_max: int

    def replica(self, d: int) -> sm.ReshardTables:
        """Replica d's tables — one object per replica, kept, so the index
        tensors the reshard route uploads for it are uploaded once."""
        cache = self.__dict__.setdefault("_replicas", {})
        if d not in cache:
            cache[d] = sm.ReshardTables(
                n=self.send_idx.shape[1], s_max=self.s_max, buf=self.buf,
                send_idx=self.send_idx[d], recv_idx=self.recv_idx[d],
                stay_idx=self.stay_idx[d],
            )
        return cache[d]


@dataclass(frozen=True)
class WeightPlan:
    """Everything needed to run one weight nonuniformly."""

    k: int                  # partition units
    buf: int                # units per rank buffer (U)
    comp_slots: np.ndarray  # (D, n, U) unit id per comp slot, -1 pad
    sync_slots: np.ndarray  # (D, n, U) unit id per sync slot, -1 pad
    pre: StackedTables      # comp -> sync
    post: StackedTables     # sync -> comp

    @property
    def comp_mask(self) -> np.ndarray:
        return self.comp_slots >= 0


def _stack(tabs, buf: int) -> StackedTables:
    s_max = max(t.s_max for t in tabs)

    def pad(a):
        out = np.full(a.shape[:-1] + (s_max,), buf, dtype=np.int32)
        out[..., : a.shape[-1]] = a
        return out

    return StackedTables(
        send_idx=np.stack([pad(t.send_idx) for t in tabs]),
        recv_idx=np.stack([pad(t.recv_idx) for t in tabs]),
        stay_idx=np.stack([t.stay_idx for t in tabs]),
        buf=buf,
        s_max=s_max,
    )


@lru_cache(maxsize=None)
def _weight_plan_cached(k: int, n1: int,
                        replica_tp: Tuple[int, ...]) -> WeightPlan:
    # layouts + tables come from the ONE Algorithm-1 planner: the same
    # cached objects drive the gradient reshard, the fail/repair
    # transitions and the serving state moves
    from repro_torch.reshard import planner

    n_sync = min(replica_tp)
    sync_key = planner.sync_key(k, n1, n_sync)
    comp_keys = [planner.comp_key(k, n1, nr, n_sync) for nr in replica_tp]
    comps = [planner.layout(ck) for ck in comp_keys]
    sync = planner.layout(sync_key)
    buf = max([sync.max_count] + [c.max_count for c in comps])

    pre = [planner.tables(ck, sync_key, buf) for ck in comp_keys]
    post = [planner.tables(sync_key, ck, buf) for ck in comp_keys]

    def slots(layout):
        out = np.full((n1, buf), -1, dtype=np.int64)
        out[:, : layout.max_count] = layout.slots
        return out

    return WeightPlan(
        k=k,
        buf=buf,
        comp_slots=np.stack([slots(c) for c in comps]),
        sync_slots=np.stack([slots(sync)] * len(replica_tp)),
        pre=_stack(pre, buf),
        post=_stack(post, buf),
    )


def weight_plan(k: int, plan: FailurePlan) -> WeightPlan:
    return _weight_plan_cached(k, plan.n1, tuple(plan.replica_tp))


# ---------------------------------------------------------------------------
# packing canonical <-> nonuniform global buffers (numpy, as the reference)

def pack_global(w: np.ndarray, wp: WeightPlan, unit: int) -> np.ndarray:
    """Canonical weight (k*unit, ...) -> global NTP buffer
    (D, n1*buf, unit, ...): replica d's rank r holds its (buf, unit, ...)
    comp-layout block at rows [r*buf, (r+1)*buf)."""
    k, buf = wp.k, wp.buf
    d, n1, _ = wp.comp_slots.shape
    cols = w.shape[1:]
    wu = np.asarray(w).reshape(k, unit, *cols)
    out = np.zeros((d, n1, buf, unit) + cols, wu.dtype)
    for dd in range(d):
        sl = wp.comp_slots[dd]
        valid = sl >= 0
        out[dd][valid] = wu[sl[valid]]
    return out.reshape(d, n1 * buf, unit, *cols)


def unpack_global(buf_arr: np.ndarray, wp: WeightPlan, unit: int,
                  replica: int = 0) -> np.ndarray:
    """Inverse of pack_global for one replica."""
    k, buf = wp.k, wp.buf
    d, n1, _ = wp.comp_slots.shape
    arr = np.asarray(buf_arr).reshape(d, n1, buf, *buf_arr.shape[2:])[replica]
    cols = arr.shape[3:]
    out = np.zeros((k, unit) + cols, arr.dtype)
    sl = wp.comp_slots[replica]
    valid = sl >= 0
    out[sl[valid]] = arr[valid]
    return out.reshape(k * unit, *cols)
