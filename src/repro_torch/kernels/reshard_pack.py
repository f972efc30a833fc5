"""NTP reshard send-bucket packing — wrapper of the hand-written CUDA kernel
`csrc/reshard_pack.cu`.

Port of the Pallas TPU kernel `repro/kernels/reshard_pack.py::reshard_pack`:
gather partition-unit rows from a rank's zero-padded unit buffer into its
per-destination all-to-all send buckets, following the static Algorithm-1
``send_idx`` table (index U selects the zero pad row). `reshard_pack_ranks`
does it for every rank of a replica in one launch and writes the stacked
send buffer ``(n, n, s_max, elems)`` directly; `reshard_pack` is the
one-rank case. The CUDA kernel writes zeros for index U without reading
the pad row, and a zero row for an index outside [0, U]; the plain
versions raise on one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, mode, ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
_LAUNCH = build.Launcher("reshard_pack", "reshard_pack_launch", _ARGS)


def reshard_pack_cost(n_idx: int, elems: int, itemsize: int,
                      n_read: int) -> mode.Cost:
    """One call writing ``n_idx`` rows of ``elems`` elements: the
    ``n_read`` distinct unit rows its indices name read once (pad rows are
    written as zeros without a read), every output row written, and the
    int32 indices read; no arithmetic."""
    return mode.Cost(0, (n_read + n_idx) * elems * itemsize + n_idx * 4)


def _dry(src, send_idx):
    """A meta call: the output's shape, and the cost with every index
    counted as a distinct row read (the values are not known), at most
    the U rows a rank holds."""
    up1, elems = src.shape[-2:]
    ranks = src.shape[0] if src.ndim == 3 else 1
    n_idx = send_idx.numel()
    mode.count_dry("reshard_pack", reshard_pack_cost(
        n_idx, elems, src.element_size(), min(n_idx, ranks * (up1 - 1))))
    return src.new_empty((*send_idx.shape, elems))


def _launch(src, send_idx, n_ranks: int):
    """One launch: ``src`` (U+1, elems), or (n_ranks, U+1, elems), and
    ``send_idx`` (n_ranks, ...) int32 → ``(*send_idx.shape, elems)``."""
    if send_idx.dtype != torch.int32:
        raise ValueError(
            f"reshard_pack: send_idx must be int32, got {send_idx.dtype}"
        )
    if not (src.is_contiguous() and send_idx.is_contiguous()):
        raise ValueError("reshard_pack: src and send_idx must be contiguous")
    up1, elems = src.shape[-2:]
    out = src.new_empty((*send_idx.shape, elems))
    _LAUNCH(src.get_device(), src.data_ptr(), send_idx.data_ptr(),
            out.data_ptr(), n_ranks, up1, send_idx.numel() // max(n_ranks, 1),
            elems * src.element_size())
    mode.count_launch("reshard_pack")
    return out


def reshard_pack(src, send_idx):
    """src: (U+1, unit_elems) — zero-padded unit buffer (last row zeros).
    send_idx: (n, s_max) int32 local slot per (dst, msg-slot), pad = U.
    Returns the send buffer (n, s_max, unit_elems) in src.dtype."""
    if src.ndim != 2 or send_idx.ndim != 2:
        raise ValueError(
            f"reshard_pack: expected src (U+1, elems) and send_idx "
            f"(n, s_max), got {tuple(src.shape)} and {tuple(send_idx.shape)}"
        )
    where = mode.device_kind(src, send_idx, kernel="reshard_pack")
    if where == "cpu":
        return ref.reshard_pack_ref(src, send_idx)
    if where == "meta":
        return _dry(src, send_idx)
    return _launch(src, send_idx, 1)


def reshard_pack_ranks(xp, send_idx):
    """Every rank's send buckets in one launch. xp: (R, U+1, unit_elems) —
    the ranks' zero-padded unit buffers; send_idx: (R, n, s_max) int32,
    rank r's table (pad = U). Returns (R, n, s_max, unit_elems) in
    xp.dtype: row [r, i, s] is xp[r, send_idx[r, i, s]]."""
    if xp.ndim != 3 or send_idx.ndim != 3 or send_idx.shape[0] != xp.shape[0]:
        raise ValueError(
            f"reshard_pack: expected xp (R, U+1, elems) and send_idx "
            f"(R, n, s_max), got {tuple(xp.shape)} and "
            f"{tuple(send_idx.shape)}"
        )
    where = mode.device_kind(xp, send_idx, kernel="reshard_pack")
    if where == "cpu":
        return ref.reshard_pack_ranks_ref(xp, send_idx)
    if where == "meta":
        return _dry(xp, send_idx)
    return _launch(xp, send_idx, xp.shape[0])
