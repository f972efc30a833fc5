"""The reshard engine's exact emulation and the transfer accounting the
transition engine's invariants hang off (port of `repro/reshard/twin.py`).

The reference runs both routes in numpy on the host; the port runs them on
torch tensors where they lie (on the card in a run), with no host round
trip:

* `emulate_tables` — the padded-message emulation (gather send buckets,
  transpose, scatter), semantically identical to `engine.reshard_ranks`
  (plain indexing, no kernel);
* `apply_plan` — the DIRECT route a packed→packed transition takes: stays
  are rank-local slot renames; movers travel in ONE fused message per
  (src, dst) rank pair across every leaf of the group, built with the
  `bucket_pack` kernel and split with `bucket_unpack` on arrival. It
  checks the central invariant — only units whose src rank differs from
  their dst rank ever enter a message — and books a `TransferStats`
  ledger of exactly what moved, bit-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import shard_mapping as sm
from repro_torch.kernels.bucket import bucket_pack, bucket_unpack
from repro_torch.reshard.planner import TransitionPlan


@dataclass
class TransferStats:
    """What one transition physically moved (the reshard engine's ledger)."""

    moved_units: int = 0      # units that changed ranks (network traffic)
    stayed_units: int = 0     # units renamed rank-locally (no traffic)
    messages: int = 0         # fused (src, dst) sends actually issued
    bytes_moved: int = 0      # payload bytes across all messages
    dense_bytes: int = 0      # what the dense host round-trip would touch
    per_pair: Dict[Tuple[int, ...], int] = field(default_factory=dict)

    def merge(self, other: "TransferStats") -> "TransferStats":
        self.moved_units += other.moved_units
        self.stayed_units += other.stayed_units
        self.bytes_moved += other.bytes_moved
        self.dense_bytes += other.dense_bytes
        for k, v in other.per_pair.items():
            if k not in self.per_pair:
                self.messages += 1    # shared tagged pairs fuse into one send
            self.per_pair[k] = self.per_pair.get(k, 0) + v
        return self

    def as_dict(self) -> Dict:
        return {
            "moved_units": self.moved_units,
            "stayed_units": self.stayed_units,
            "messages": self.messages,
            "bytes_moved": self.bytes_moved,
            "dense_bytes": self.dense_bytes,
        }


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).long()


def emulate_tables(x_ranks: torch.Tensor,
                   tables: sm.ReshardTables) -> torch.Tensor:
    """Message-table twin of `engine.reshard_ranks` on one (n, buf, ...)
    rank-buffer stack (recv_r[j] = send_j[r]; pad gathers zeros / drops)."""
    n, buf = x_ranks.shape[:2]
    if buf != tables.buf:
        raise ValueError(f"buffer of {buf} slots, tables expect {tables.buf}")
    dev = x_ranks.device
    zero = x_ranks.new_zeros((n, 1) + x_ranks.shape[2:])
    xp = torch.cat([x_ranks, zero], dim=1)
    send = _idx(tables.send_idx, dev)
    send_buf = torch.stack([xp[r][send[r]] for r in range(n)])
    recv_buf = send_buf.transpose(0, 1)
    stay = _idx(tables.stay_idx, dev)
    out = torch.empty_like(x_ranks)
    for r in range(n):
        o = xp[r][stay[r]]
        flat = recv_buf[r].reshape((-1,) + recv_buf.shape[3:])
        slots = tables.recv_idx[r].reshape(-1)
        keep = slots != tables.pad
        o[_idx(slots[keep], dev)] = flat[_idx(keep.nonzero()[0], dev)]
        out[r] = o
    return out


def apply_plan(
    bufs: Sequence[torch.Tensor],
    plan: TransitionPlan,
    *,
    stats: Optional[TransferStats] = None,
    pair_tag: Tuple = (),
    outs: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Direct packed→packed transition of a GROUP of leaves sharing one
    plan: ``bufs`` is a list of (n, src_buf, *payload) rank-buffer stacks;
    returns the (n, dst_buf, *payload) stacks under the destination layout
    (written into ``outs`` when given — zero-filled tensors of that shape —
    else into fresh zero tensors).

    Stays never leave their rank; movers ride ONE fused message per
    (src, dst) pair across every leaf in the group (one per dtype when the
    group mixes dtypes). ``pair_tag`` prefixes the ``per_pair`` ledger keys
    (callers tag the replica, so messages of DIFFERENT unit families to the
    same (replica, src, dst) count once, as in the reference)."""
    n = plan.n
    if outs is None:
        outs = [b.new_zeros((n, plan.dst_buf) + b.shape[2:]) for b in bufs]
    dev = bufs[0].device if bufs else None
    stay_rank = _idx(plan.stay_rank, dev)
    stay_src = _idx(plan.stay_src_slot, dev)
    stay_dst = _idx(plan.stay_dst_slot, dev)
    for b, o in zip(bufs, outs):
        if tuple(b.shape[:2]) != (n, plan.src_buf):
            raise ValueError(
                f"leaf {tuple(b.shape)} is not ({n}, {plan.src_buf}, ...)")
        # stays: rank-local slot renames, zero network traffic
        o[stay_rank, stay_dst] = b[stay_rank, stay_src]

    st = stats if stats is not None else TransferStats()
    st.stayed_units += plan.n_stay * len(bufs)
    st.dense_bytes += sum(b.numel() * b.element_size() for b in bufs)
    src, dst = plan.move_src_rank, plan.move_dst_rank
    if (src == dst).any():
        raise AssertionError("a stay leaked into the move set")
    for s, d in plan.pairs:
        sel = (src == s) & (dst == d)
        n_units = int(sel.sum())
        src_slots = _idx(plan.move_src_slot[sel], dev)
        dst_slots = _idx(plan.move_dst_slot[sel], dev)
        key = pair_tag + (s, d)
        if key not in st.per_pair:
            st.messages += 1          # families sharing a tagged pair fuse
        st.moved_units += n_units * len(bufs)
        st.per_pair[key] = st.per_pair.get(key, 0) + n_units
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, b in enumerate(bufs):
            by_dtype.setdefault(b.dtype, []).append(i)
        for members in by_dtype.values():
            # ONE fused message: every leaf's movers for this (src, dst)
            # pair, side by side in one (n_units, ΣE) buffer
            payload = [bufs[i][s].index_select(0, src_slots)
                       .reshape(n_units, -1) for i in members]
            st.bytes_moved += sum(p.numel() * p.element_size()
                                  for p in payload)
            message = bucket_pack(payload)
            parts = bucket_unpack(message, tuple(p.shape[1] for p in payload))
            for i, p in zip(members, parts):
                outs[i][d][dst_slots] = p.reshape(
                    (n_units,) + tuple(bufs[i].shape[2:]))
    return list(outs)
