"""ShardedState: the sharded form of a per-request state dict (the KV cache,
or the Mamba-2 h/conv state) over one scale-up domain, with live
TP-transition resharding (port of `repro/reshard/state.py`).

Each leaf's partition axis is split into its family's units, placed by the
planner's degree layouts (``sync_key(k, n1, tp)`` — contiguously balanced
over the first ``tp`` live ranks), and a TP change moves units between
ranks with the static-table all-to-all of `reshard.engine`, fused per unit
family (one message per (src, dst) rank pair for all leaves sharing a
plan). Replicated tails (the conv state's B/C columns) ride along dense:
they exist on every rank and never move. The ranks are emulated on one
device, as in the reference.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import shard_mapping as sm
from repro_torch.reshard import engine, planner
from repro_torch.reshard.units import UnitSpec


@lru_cache(maxsize=None)
def degree_layout(k: int, tp: int, n1: int) -> sm.Layout:
    """Unit→rank placement of a replica serving at TP degree ``tp``:
    contiguously balanced over its first ``tp`` live ranks on the full
    ``n1``-wide domain axis."""
    if not 1 <= tp <= n1:
        raise ValueError(f"tp={tp} outside [1, n1={n1}]")
    return planner.layout(planner.sync_key(k, n1, tp))


def widened_slots(layout: sm.Layout, buf: int) -> np.ndarray:
    """(n, buf) unit id per buffer slot, -1 pad (layout.slots widened to a
    common ``buf`` so every TP degree shares one buffer geometry)."""
    assert buf >= layout.max_count
    out = np.full((layout.n, buf), -1, dtype=np.int64)
    out[:, : layout.max_count] = layout.slots
    return out


def _norm_axis(spec: UnitSpec, ndim: int) -> int:
    ax = spec.axis if spec.axis >= 0 else spec.axis + ndim
    assert 0 <= ax < ndim, (spec, ndim)
    return ax


def shard_state_leaf(dense, spec: UnitSpec, layout: sm.Layout, buf: int):
    """Dense leaf → ((n1, buf, [unit,] *other) rank buffers, dense tail).

    The ``spec.axis`` slice ``[0, k·unit)`` moves into per-rank unit
    buffers (pad slots exact zeros), placed by ``layout``; the replicated
    ``tail`` channels stay dense (None without a tail). The unit channel
    dim is kept only when ``unit > 1``."""
    ax = _norm_axis(spec, dense.ndim)
    span = spec.k * spec.unit
    if dense.shape[ax] != span + spec.tail:
        raise ValueError(f"leaf {tuple(dense.shape)} axis {ax} is not {spec}")
    tail = dense.narrow(ax, span, spec.tail).clone() if spec.tail else None
    x = dense.narrow(ax, 0, span).movedim(ax, 0)     # (k·unit, *other)
    if spec.unit > 1:
        x = x.reshape(spec.k, spec.unit, *x.shape[1:])
    xp = engine.zero_pad_slot(x, axis=0)             # index k → zeros
    slots = widened_slots(layout, buf)
    idx = torch.as_tensor(np.where(slots >= 0, slots, spec.k),
                          device=dense.device)
    return xp[idx], tail


def gather_state_leaf(sharded, tail, spec: UnitSpec, layout: sm.Layout,
                      ndim: int):
    """Inverse of `shard_state_leaf`: only live (rank, slot) pairs are read
    — pad contents never leak into the dense view."""
    dev = sharded.device
    x = sharded[torch.as_tensor(layout.assignment, device=dev),
                torch.as_tensor(layout.local_slot, device=dev)]
    if spec.unit > 1:
        x = x.reshape(spec.k * spec.unit, *x.shape[2:])
    ax = _norm_axis(spec, ndim)
    out = x.movedim(0, ax)
    if tail is not None:
        out = torch.cat([out, tail], dim=ax)
    return out.contiguous()


class ShardedState:
    """The sharded per-request state of ONE serving replica.

    Owns every unit-bearing leaf of a state dict in rank buffers over an
    ``n1``-wide scale-up domain and reshards them when the replica's TP
    degree changes (`apply_tp`). `gather()` returns the dense view (shard ∘
    gather is the bit-exact identity). ``resolver`` maps a leaf name
    to its `UnitSpec` (`units.cache_unit_resolver`).
    """

    def __init__(self, tree: Dict[str, torch.Tensor], resolver: Callable,
                 n1: int, *, tp: Optional[int] = None):
        self.n1 = n1
        self._tp = n1 if tp is None else tp
        self._names = list(tree)
        self._specs: List[UnitSpec] = [resolver(n) for n in self._names]
        self._ndims = [tree[n].ndim for n in self._names]
        self._shard(tree)
        self.last_reshard: Dict[str, Any] = {}

    def _layout(self, spec: UnitSpec, tp: int) -> sm.Layout:
        return degree_layout(spec.k, tp, self.n1)

    def _shard(self, tree: Dict[str, torch.Tensor]) -> None:
        self._bufs, self._tails = [], []
        for n, spec in zip(self._names, self._specs):
            b, t = shard_state_leaf(tree[n], spec,
                                    self._layout(spec, self._tp), spec.k)
            self._bufs.append(b)
            self._tails.append(t)

    # -------------------------------------------------------------- views

    @property
    def tp(self) -> int:
        return self._tp

    @property
    def sharded(self) -> List:
        """The raw (n1, buf, ...) rank buffers (tests / introspection)."""
        return list(self._bufs)

    def gather(self) -> Dict[str, torch.Tensor]:
        """Dense state dict view for the decode step."""
        return {
            n: gather_state_leaf(b, t, spec, self._layout(spec, self._tp), nd)
            for n, b, t, spec, nd in zip(
                self._names, self._bufs, self._tails, self._specs, self._ndims
            )
        }

    def update(self, tree: Dict[str, torch.Tensor]) -> None:
        """Re-scatter a dense state dict with this state's leaf names into
        the current rank layout."""
        if sorted(tree) != sorted(self._names):
            raise ValueError(f"leaves {sorted(tree)} are not this state's "
                             f"{sorted(self._names)}")
        self._shard(tree)

    # ------------------------------------------------------------- reshard

    def apply_tp(self, new_tp: int) -> Dict[str, Any]:
        """Reshard every leaf from the current layout to the ``new_tp``
        layout (downward on failure, upward on recovery), fused per unit
        family, and return the traffic stats of the move.
        ``moved_units_per_rank`` counts unit INSTANCES (one per leaf
        carrying the unit, summed over families) through the busiest rank —
        the same accounting basis as ``bytes_moved``."""
        if not 1 <= new_tp <= self.n1:
            raise ValueError(f"new_tp={new_tp} outside [1, n1={self.n1}]")
        stats = {
            "tp_from": self._tp, "tp_to": new_tp,
            "moved_units_per_rank": 0, "bytes_moved": 0, "messages": 0,
        }
        if new_tp == self._tp:
            self.last_reshard = stats
            return stats

        groups: Dict[int, List[int]] = {}
        for i, spec in enumerate(self._specs):
            groups.setdefault(spec.k, []).append(i)
        pairs = set()
        per_rank = np.zeros(self.n1, dtype=np.int64)
        for k, idxs in groups.items():
            plan = planner.transition_plan(
                planner.sync_key(k, self.n1, self._tp),
                planner.sync_key(k, self.n1, new_tp),
                k, k,
            )
            outs = engine.reshard_group(
                [self._bufs[i] for i in idxs], plan.tables
            )
            for i, o in zip(idxs, outs):
                unit_bytes = (self._bufs[i][0, 0].numel()
                              * self._bufs[i].element_size())
                stats["bytes_moved"] += plan.n_moved * unit_bytes
                self._bufs[i] = o
            pairs.update(plan.pairs)   # families sharing a pair fuse
            # every family's moves land on the same ranks in the same
            # transition: per-rank traffic is the SUM over families
            per_rank += plan.tables.moved_units_per_rank() * len(idxs)
        stats["moved_units_per_rank"] = int(per_rank.max())
        stats["messages"] = len(pairs)
        self._tp = new_tp
        self.last_reshard = stats
        return stats
