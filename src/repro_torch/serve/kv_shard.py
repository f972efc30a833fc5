"""KV-cache sharding on the TP axis and the live head-redistribution
reshard (port of `repro/serve/kv_shard.py`): a thin attention-specific
layer over the reshard engine (`repro_torch.reshard`).

GQA KV heads are the partition units over the scale-up domain: a replica
at TP degree ``t`` holds its heads contiguously balanced over its first
``t`` live ranks (`head_layout`, the planner's degree layout; with fewer
heads than ranks some live ranks hold none), and a TP transition moves
heads between ranks with the same Algorithm-1 static-table all-to-all as
every other unit family (`head_reshard_tables` → `reshard_leaf`, which
is `reshard.engine.reshard_ranks`: the hand-written `kernels.reshard_pack`
packs the send buckets of a CUDA leaf, its plain version those of a CPU
leaf).

Leaves are dense (..., T, kvh, hd) — the head axis at -2 — and sharded
leaves are (n1, buf, ..., T, hd) rank buffers whose pad slots hold exact
zeros. `attend_from_sharded` evaluates attention rank-locally from the
sharded buffers: pad slots can never reach its output. `ShardedKV` is the
`reshard.ShardedState` of a cache whose every leaf is a ``k``/``v``
tensor; the serve engine holds caches with recurrent state or an encoder
bank through `ShardedState` itself.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import shard_mapping as sm
from repro_torch.reshard import engine, planner
from repro_torch.reshard.state import ShardedState, degree_layout, widened_slots
from repro_torch.reshard.units import UnitSpec

KV_LEAF_NAMES = ("k", "v")
_KV_AXIS = -2


def validate_kv_cache(cache: Dict[str, torch.Tensor]) -> None:
    """Every leaf must be a ``k``/``v`` KV-cache tensor (``k``, ``k.<g>``,
    ``k.t<j>``). Recurrent state (``h``/``conv``) and the encoder bank
    (``ek``/``ev``) have their own unit families: serve them through
    `reshard.ShardedState` with `units.cache_unit_resolver`."""
    for name in cache:
        if name.partition(".")[0] not in KV_LEAF_NAMES:
            raise ValueError(
                f"ShardedKV shards k/v leaves only; got {name!r} (recurrent "
                "state and encoder banks have their own unit families — use "
                "reshard.ShardedState with units.cache_unit_resolver)"
            )


# ---------------------------------------------------------------------------
# layouts (planner-backed)

def head_layout(kvh: int, tp: int, n1: int) -> sm.Layout:
    """Head → rank placement of a replica serving at TP degree ``tp``: the
    planner's degree layout, contiguously balanced over the first ``tp``
    live ranks of the ``n1``-wide domain. ``kvh < tp`` leaves some live
    ranks without a KV head."""
    return degree_layout(kvh, tp, n1)


def slots_at(layout: sm.Layout, buf: int) -> np.ndarray:
    """(n, buf) head id per buffer slot, -1 pad (`reshard.widened_slots`)."""
    return widened_slots(layout, buf)


@lru_cache(maxsize=None)
def head_reshard_tables(kvh: int, tp_from: int, tp_to: int,
                        n1: int) -> sm.ReshardTables:
    """Static all-to-all tables moving every KV head from its ``tp_from``
    placement to its ``tp_to`` placement (buf = kvh: the TP 1 worst case,
    so no transition reallocates)."""
    return planner.tables(planner.sync_key(kvh, n1, tp_from),
                          planner.sync_key(kvh, n1, tp_to), kvh)


# ---------------------------------------------------------------------------
# leaf ops

def shard_leaf(dense, layout: sm.Layout, buf: int):
    """(..., T, kvh, hd) → (n1, buf, ..., T, hd); pad slots exact zeros."""
    kvh = dense.shape[_KV_AXIS]
    if kvh != layout.k:
        raise ValueError(f"leaf has {kvh} KV heads, layout {layout.k}")
    xp = engine.zero_pad_slot(dense.movedim(_KV_AXIS, 0), axis=0)
    slots = widened_slots(layout, buf)
    return xp[torch.as_tensor(np.where(slots >= 0, slots, kvh),
                              device=dense.device)]


def gather_leaf(sharded, layout: sm.Layout):
    """Inverse of `shard_leaf`: (n1, buf, ..., T, hd) → (..., T, kvh, hd).
    Only live (rank, slot) pairs are read — pad contents never leak."""
    dev = sharded.device
    x = sharded[torch.as_tensor(layout.assignment, device=dev),
                torch.as_tensor(layout.local_slot, device=dev)]
    return x.movedim(0, _KV_AXIS)


def reshard_leaf(x, tables: sm.ReshardTables):
    """Head-redistribution all-to-all on one sharded leaf (n1, buf, *rest):
    gather send buckets → transpose (``recv_r[j] = send_j[r]``) → stays +
    scatter (`reshard.engine.reshard_ranks`: `kernels.reshard_pack` packs
    the buckets on the card)."""
    return engine.reshard_ranks(x, tables)


# ---------------------------------------------------------------------------
# attention from sharded buffers (rank-local math; the pad-leak oracle)

def attend_heads(q, k, v, mask):
    """Dense GQA attention core, f32: q (B, H, g, Sq, hd); k/v (B, T, H,
    hd); mask (Sq, T) bool (True = attend). Per-head math is independent,
    which makes the rank-local evaluation below equal to it."""
    hd = q.shape[-1]
    s = torch.einsum("bhgqd,bthd->bhgqt", q.float(), k.float()) * hd ** -0.5
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqt,bthd->bhgqd", p, v.float())


def attend_from_sharded(q, sk, sv, layout: sm.Layout, mask):
    """`attend_heads` evaluated rank-locally from sharded K/V buffers: each
    rank attends only its local head slots, and per-head outputs are
    assembled by the head → rank map, so pad-slot contents (even NaN)
    never reach the output. q (B, kvh, g, Sq, hd); sk/sv (n1, buf, B, T,
    hd). Returns (B, kvh, g, Sq, hd) f32."""
    n1, buf = sk.shape[:2]
    b, t, hd = sk.shape[2], sk.shape[-2], sk.shape[-1]
    dev = q.device
    slots = widened_slots(layout, buf).reshape(-1)        # (n1·buf,)
    q_sl = q[:, torch.as_tensor(np.maximum(slots, 0), device=dev)]
    # (n1, buf, B, T, hd) → (B, T, n1·buf, hd): the slot axis plays "head"
    k_sl = sk.reshape(n1 * buf, b, t, hd).movedim(0, 2)
    v_sl = sv.reshape(n1 * buf, b, t, hd).movedim(0, 2)
    out_sl = attend_heads(q_sl, k_sl, v_sl, mask)
    head_to_flat = layout.assignment * buf + layout.local_slot   # (kvh,)
    return out_sl[:, torch.as_tensor(head_to_flat, device=dev)]


# ---------------------------------------------------------------------------
# whole-cache container

class ShardedKV(ShardedState):
    """The sharded KV cache of ONE serving replica: the `ShardedState` of a
    cache dict whose every leaf is a ``k``/``v`` tensor, with GQA-head
    units at axis -2 (buf = kvh, so every TP degree shares one buffer
    geometry)."""

    def __init__(self, cache: Dict[str, torch.Tensor], kvh: int, n1: int, *,
                 tp: Optional[int] = None):
        validate_kv_cache(cache)
        self.kvh = kvh
        self.buf = kvh
        spec = UnitSpec("kv_head", kvh, axis=_KV_AXIS)
        super().__init__(cache, lambda name: spec, n1, tp=tp)

    @property
    def layout(self) -> sm.Layout:
        return head_layout(self.kvh, self.tp, self.n1)

    def apply_tp(self, new_tp: int) -> Dict[str, Any]:
        stats = super().apply_tp(new_tp)
        # the reference's KV-specific name for the engine's unit count
        stats["moved_heads_per_rank"] = stats["moved_units_per_rank"]
        self.last_reshard = stats
        return stats
