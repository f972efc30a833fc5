"""The reshard route on ``(n, buf, ...)`` rank-buffer stacks: static-table
gather → all-to-all → scatter, with the replica's ranks emulated on one
device (port of `repro/reshard/engine.py`).

The send-bucket gather of every rank runs the hand-written
`kernels.reshard_pack` kernel on the card (its plain version on the CPU);
the all-to-all is the host-unrolled transpose ``recv_r[j] = send_j[r]``;
stays and the receive scatter are plain tensor indexing, as in the
reference.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core import shard_mapping as sm
from repro_torch.kernels.reshard_pack import reshard_pack


def zero_pad_slot(x, axis: int = 0):
    """Append one zero slot along ``axis`` — the pad sentinel every table
    gathers zeros from (index ``buf``)."""
    shape = list(x.shape)
    shape[axis] = 1
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def gather_send_buckets(xp, send_idx):
    """Per-rank send-bucket gather: ``xp`` (n, buf+1, *rest) zero-padded
    buffers, ``send_idx`` (n, n, s_max) int32 on xp's device →
    (n, n, s_max, *rest); one `reshard_pack` launch per rank."""
    n, bufp1 = xp.shape[:2]
    rest = xp.shape[2:]
    s_max = send_idx.shape[-1]
    flat = xp.reshape(n, bufp1, -1)
    return torch.stack(
        [reshard_pack(flat[r], send_idx[r]) for r in range(n)]
    ).reshape(n, n, s_max, *rest)


def reshard_ranks(x, tables: sm.ReshardTables):
    """One layout change on a rank-buffer stack ``x`` (n, buf, *rest):
    gather send buckets → tiled all-to-all (host-unrolled transpose:
    recv_r[j] = send_j[r]) → stays + scatter. Pad slots (== buf) gather
    zeros and scatter-drop, so output pad slots are exact zeros."""
    n, buf = x.shape[:2]
    if buf != tables.buf:
        raise ValueError(f"buffer of {buf} slots, tables expect {tables.buf}")
    dev = x.device
    xp = zero_pad_slot(x, axis=1)
    send = gather_send_buckets(
        xp, torch.as_tensor(tables.send_idx, device=dev)
    )
    recv = send.transpose(0, 1)                  # recv_r[j] = send_j[r]

    stay = torch.as_tensor(tables.stay_idx, device=dev).long()
    out = torch.stack([xp[r][stay[r]] for r in range(n)])
    flat_recv = recv.reshape(n, n * tables.s_max, *x.shape[2:])
    recv_slots = tables.recv_idx.reshape(n, -1)
    for r in range(n):
        keep = recv_slots[r] != tables.pad      # pad (== buf) drops
        if keep.any():
            out[r][torch.as_tensor(recv_slots[r][keep], device=dev).long()] = \
                flat_recv[r][torch.as_tensor(keep, device=dev)]
    return out


def reshard_group(xs: Sequence, tables: sm.ReshardTables) -> List:
    """Fused multi-leaf reshard: every leaf shares one plan, so their unit
    payloads are concatenated and the whole group moves through ONE
    gather/all-to-all/scatter — one message per (src, dst) rank pair for
    the group, instead of one per tensor."""
    xs = list(xs)
    if len(xs) == 1:
        return [reshard_ranks(xs[0], tables)]
    n, buf = xs[0].shape[:2]
    if not all(x.is_floating_point() for x in xs) and \
            len({x.dtype for x in xs}) > 1:
        # promotion must be value-exact: int → float is not (>2^24)
        raise ValueError(
            "mixed-dtype reshard group must be all-floating; give non-float "
            f"leaves their own group: {[x.dtype for x in xs]}"
        )
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    flats, sizes = [], []
    for x in xs:
        if x.shape[:2] != (n, buf):
            raise ValueError(f"leaf {tuple(x.shape)} is not ({n}, {buf}, ...)")
        flats.append(x.reshape(n, buf, -1).to(dtype))
        sizes.append(flats[-1].shape[-1])
    out = reshard_ranks(torch.cat(flats, dim=-1), tables)
    outs, off = [], 0
    for x, e in zip(xs, sizes):
        outs.append(out[..., off:off + e].to(x.dtype).reshape(x.shape))
        off += e
    return outs
