"""Paper §3.1 "Shard-mapping algorithm" (Algorithm 1): comp/sync rank
assignment for nonuniform tensor parallelism.

Terminology (paper): a weight's TP partition dimension is split into ``k``
*units* (we use 128-row blocks / attention-head groups / experts — DESIGN.md
§3.2, the TPU adaptation of the paper's row granularity).

* **sync layout** — the canonical layout used for cross-replica gradient
  synchronization: units contiguously sharded over the ``n2`` sync ranks
  (``n2`` = the reduced TP degree). A degraded replica *computes* in this
  layout too (the paper: "on unhealthy replicas, A/B … are sharded
  contiguously across N2 GPUs").
* **comp layout** — the layout healthy replicas compute in: balanced over all
  ``n1`` ranks, constructed so that sync rank ``j`` keeps the leading units of
  its own sync shard and the overflow is round-robined over the ``n1-n2``
  *offload* ranks, equalizing pairwise reshard traffic (Algorithm 1's
  ``offload_idx`` rotation).

Pure numpy — the port's copy of `repro/core/shard_mapping.py`; its tables
must stay bit-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np


def balanced_sizes(k: int, n: int) -> np.ndarray:
    """Contiguous balanced partition sizes (first k%n ranks get one extra)."""
    q, r = divmod(k, n)
    return np.array([q + 1 if i < r else q for i in range(n)], dtype=np.int64)


def sync_assignment(k: int, n2: int) -> np.ndarray:
    """Unit -> sync rank (contiguous, balanced over ranks [0, n2))."""
    sizes = balanced_sizes(k, n2)
    return np.repeat(np.arange(n2), sizes)


def comp_assignment(k: int, n1: int, n2: int) -> np.ndarray:
    """Algorithm 1: unit -> comp rank for a HEALTHY replica (n1 ranks) whose
    gradients must end up in the n2-contiguous sync layout.

    Invariants (property-tested):
      * comp loads are balanced over n1 ranks (max-min <= 1);
      * sync rank j keeps a prefix of its own sync shard (minimal motion);
      * overflow units rotate over offload ranks [n2, n1) (balanced pairwise
        reshard traffic);
      * n1 == n2  ->  comp == sync (zero reshard traffic).
    """
    assert 1 <= n2 <= n1 and k >= n1, (k, n1, n2)
    sync = sync_assignment(k, n2)
    target = balanced_sizes(k, n1)
    comp = np.empty(k, dtype=np.int64)

    n_off = n1 - n2
    if n_off == 0:
        return sync.copy()

    # overflow capacity of each offload rank
    cap = target[n2:].copy()
    fill = np.zeros(n_off, dtype=np.int64)
    offload_idx = 0
    for j in range(n2):
        units = np.where(sync == j)[0]          # contiguous
        keep = min(len(units), target[j])
        comp[units[:keep]] = j
        for u in units[keep:]:
            # rotate over offload ranks, skipping full ones
            for _ in range(n_off):
                cand = offload_idx % n_off
                offload_idx += 1
                if fill[cand] < cap[cand]:
                    comp[u] = n2 + cand
                    fill[cand] += 1
                    break
            else:  # pragma: no cover — capacities sum to the overflow total
                raise AssertionError("offload capacity exhausted")
    return comp


# ---------------------------------------------------------------------------
# layouts + reshard tables

@dataclass(frozen=True)
class Layout:
    """A placement of k units onto n ranks (ranks may be empty)."""

    k: int
    n: int
    assignment: np.ndarray          # (k,) unit -> rank
    counts: np.ndarray              # (n,)
    local_slot: np.ndarray          # (k,) slot of unit within its rank buffer
    max_count: int

    @property
    def slots(self) -> np.ndarray:
        """(n, max_count) unit id per buffer slot, -1 = padding."""
        out = np.full((self.n, self.max_count), -1, dtype=np.int64)
        for u in range(self.k):
            out[self.assignment[u], self.local_slot[u]] = u
        return out


def make_layout(assignment: np.ndarray, n: int) -> Layout:
    k = len(assignment)
    counts = np.bincount(assignment, minlength=n).astype(np.int64)
    local_slot = np.empty(k, dtype=np.int64)
    next_slot = np.zeros(n, dtype=np.int64)
    for u in range(k):  # unit-id order within each rank (canonical)
        r = assignment[u]
        local_slot[u] = next_slot[r]
        next_slot[r] += 1
    return Layout(k, n, assignment.copy(), counts, local_slot, int(counts.max()))


def comp_layout(k: int, n1: int, n2: int) -> Layout:
    return make_layout(comp_assignment(k, n1, n2), n1)


def sync_layout(k: int, n1: int, n2: int) -> Layout:
    """Sync layout expressed on the full n1-rank axis (ranks >= n2 empty)."""
    return make_layout(sync_assignment(k, n2), n1)


def transfer_matrix(src: Layout, dst: Layout) -> np.ndarray:
    """(n, n) units moved from src-rank to dst-rank (diagonal = stays)."""
    m = np.zeros((src.n, dst.n), dtype=np.int64)
    for u in range(src.k):
        m[src.assignment[u], dst.assignment[u]] += 1
    return m


@dataclass(frozen=True)
class ReshardTables:
    """Static index tables driving the all-to-all reshard (padded messages).

    All buffers are a common ``buf`` units long (zero-padded beyond each
    rank's count); index ``buf`` is the pad sentinel (gathers a zero row /
    scatter-drops).

    send_idx[r, d, s]  = local slot in r's src buffer of the s-th unit that
                         rank r sends to rank d  (pad if none)
    recv_idx[r, j, s]  = local slot in r's dst buffer where the unit received
                         from rank j at message slot s lands (pad drops)
    stay_idx[r, t]     = src slot feeding dst slot t when the unit does not
                         change ranks (pad -> zero)
    """

    n: int
    s_max: int
    buf: int
    send_idx: np.ndarray   # (n, n, s_max) int32
    recv_idx: np.ndarray   # (n, n, s_max) int32
    stay_idx: np.ndarray   # (n, buf) int32

    @property
    def pad(self) -> int:
        return self.buf

    def moved_units_per_rank(self) -> np.ndarray:
        """max(send, recv) units per rank (network-moved, excl. stays)."""
        send = (self.send_idx != self.pad).sum(axis=(1, 2))
        recv = (self.recv_idx != self.pad).sum(axis=(1, 2))
        return np.maximum(send, recv)


def reshard_tables(src: Layout, dst: Layout, buf: int | None = None) -> ReshardTables:
    assert src.k == dst.k and src.n == dst.n
    n, k = src.n, src.k
    buf = buf if buf is not None else max(src.max_count, dst.max_count)
    assert buf >= max(src.max_count, dst.max_count)
    msgs: Dict[Tuple[int, int], list] = {}
    stays: list = []
    for u in range(k):  # unit-id order => deterministic message order
        r, d = int(src.assignment[u]), int(dst.assignment[u])
        if r != d:
            msgs.setdefault((r, d), []).append(u)
        else:
            stays.append(u)
    s_max = max((len(v) for v in msgs.values()), default=0)
    s_max = max(s_max, 1)  # keep arrays non-empty

    send_idx = np.full((n, n, s_max), buf, dtype=np.int32)
    recv_idx = np.full((n, n, s_max), buf, dtype=np.int32)
    stay_idx = np.full((n, buf), buf, dtype=np.int32)
    for (r, d), units in msgs.items():
        for s, u in enumerate(units):
            send_idx[r, d, s] = src.local_slot[u]
            recv_idx[d, r, s] = dst.local_slot[u]
    for u in stays:
        r = int(src.assignment[u])
        stay_idx[r, dst.local_slot[u]] = src.local_slot[u]
    return ReshardTables(
        n=n, s_max=s_max, buf=buf, send_idx=send_idx, recv_idx=recv_idx,
        stay_idx=stay_idx,
    )


@lru_cache(maxsize=None)
def plan(k: int, n1: int, n2: int, buf: int | None = None):
    """(comp_layout, sync_layout, pre_tables, post_tables) for one weight."""
    c = comp_layout(k, n1, n2)
    s = sync_layout(k, n1, n2)
    b = buf if buf is not None else max(c.max_count, s.max_count)
    pre = reshard_tables(c, s, b)
    post = reshard_tables(s, c, b)
    return c, s, pre, post


def reshard_bytes_per_rank(src: Layout, dst: Layout, unit_bytes: int) -> np.ndarray:
    """Max(send, recv) bytes per rank — the paper's Fig. 8 x-axis numerator."""
    m = transfer_matrix(src, dst)
    off = m - np.diag(np.diag(m))
    return np.maximum(off.sum(1), off.sum(0)) * unit_bytes
