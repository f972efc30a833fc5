"""The reshard route on ``(n, buf, ...)`` rank-buffer stacks: static-table
gather → all-to-all → scatter, with the replica's ranks emulated on one
device (port of `repro/reshard/engine.py`).

The send-bucket gather of all ranks is one launch of the hand-written
`kernels.reshard_pack` kernel on the card (`reshard_pack_ranks`, which
writes the stacked send buffer; its plain version on the CPU);
the all-to-all is the host-unrolled transpose ``recv_r[j] = send_j[r]``;
stays and the receive scatter are plain tensor indexing, as in the
reference. The tables' index tensors are uploaded once per (tables,
device) and kept (`device_tables`), and the scatter uses integer indices,
so a reshard issues no host-to-device copy and no data-dependent shape:
nothing in it makes the host wait for the stream (the overlapped gradient
sync issues reshards while the backward is still running).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import shard_mapping as sm
from repro_torch.kernels.reshard_pack import reshard_pack_ranks


def zero_pad_slot(x, axis: int = 0):
    """Append one zero slot along ``axis`` — the pad sentinel every table
    gathers zeros from (index ``buf``)."""
    shape = list(x.shape)
    shape[axis] = 1
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def gather_send_buckets(xp, send_idx):
    """Send-bucket gather of every rank: ``xp`` (n, buf+1, *rest)
    zero-padded buffers, ``send_idx`` (n, n, s_max) int32 on xp's device →
    the stacked send buffer (n, n, s_max, *rest); one `reshard_pack`
    launch for all n ranks."""
    n, bufp1 = xp.shape[:2]
    return reshard_pack_ranks(xp.reshape(n, bufp1, -1), send_idx).reshape(
        *send_idx.shape, *xp.shape[2:])


def device_tables(tables: sm.ReshardTables, device) -> Dict:
    """The index tensors of ``tables`` on ``device``: send (n, n, s_max)
    int32, stay (n, buf) int64, and per rank the flat receive positions
    that land (``recv_src``) with their destination slots (``recv_dst``).
    Built at the first call and kept on the (immutable) tables object."""
    cache = tables.__dict__.setdefault("_on_device", {})
    key = str(torch.device(device))
    if key not in cache:
        n = tables.n
        recv = tables.recv_idx.reshape(n, -1)
        land = [np.nonzero(recv[r] != tables.pad)[0] for r in range(n)]
        cache[key] = {
            "send": torch.as_tensor(tables.send_idx, device=device),
            "stay": torch.as_tensor(tables.stay_idx, device=device).long(),
            "recv_src": [torch.as_tensor(p, device=device) for p in land],
            "recv_dst": [torch.as_tensor(recv[r][p], device=device).long()
                         for r, p in enumerate(land)],
        }
    return cache[key]


def reshard_ranks(x, tables: sm.ReshardTables):
    """One layout change on a rank-buffer stack ``x`` (n, buf, *rest):
    gather send buckets → tiled all-to-all (host-unrolled transpose:
    recv_r[j] = send_j[r]) → stays + scatter. Pad slots (== buf) gather
    zeros and scatter-drop, so output pad slots are exact zeros."""
    n, buf = x.shape[:2]
    if buf != tables.buf:
        raise ValueError(f"buffer of {buf} slots, tables expect {tables.buf}")
    t = device_tables(tables, x.device)
    xp = zero_pad_slot(x, axis=1)
    send = gather_send_buckets(xp, t["send"])
    recv = send.transpose(0, 1)                  # recv_r[j] = send_j[r]

    out = torch.stack([xp[r][t["stay"][r]] for r in range(n)])
    flat_recv = recv.reshape(n, n * tables.s_max, *x.shape[2:])
    for r in range(n):
        if len(t["recv_src"][r]):               # pad (== buf) drops
            out[r][t["recv_dst"][r]] = flat_recv[r][t["recv_src"][r]]
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
