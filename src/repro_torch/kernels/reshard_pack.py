"""NTP reshard send-bucket packing — wrapper of the hand-written CUDA kernel
`csrc/reshard_pack.cu`.

Port of the Pallas TPU kernel `repro/kernels/reshard_pack.py::reshard_pack`:
gather partition-unit rows from a rank's zero-padded unit buffer into its
per-destination all-to-all send buckets, following the static Algorithm-1
``send_idx`` table (index U selects the zero pad row). The CUDA kernel
writes a zero row for an index outside [0, U]; the plain version raises
on one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, mode, ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def reshard_pack(src, send_idx):
    """src: (U+1, unit_elems) — zero-padded unit buffer (last row zeros).
    send_idx: (n, s_max) int32 local slot per (dst, msg-slot), pad = U.
    Returns the send buffer (n, s_max, unit_elems) in src.dtype."""
    if src.ndim != 2 or send_idx.ndim != 2:
        raise ValueError(
            f"reshard_pack: expected src (U+1, elems) and send_idx "
            f"(n, s_max), got {tuple(src.shape)} and {tuple(send_idx.shape)}"
        )
    up1, elems = src.shape
    n, s_max = send_idx.shape
    if mode.on_cpu(src, send_idx, kernel="reshard_pack"):
        return ref.reshard_pack_ref(src, send_idx)
    if send_idx.dtype != torch.int32:
        raise ValueError(
            f"reshard_pack: send_idx must be int32, got {send_idx.dtype}"
        )
    if not (src.is_contiguous() and send_idx.is_contiguous()):
        raise ValueError("reshard_pack: src and send_idx must be contiguous")
    out = torch.empty((n, s_max, elems), dtype=src.dtype, device=src.device)
    fn = build.function("reshard_pack", "reshard_pack_launch", _ARGS)
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), send_idx.data_ptr(), out.data_ptr(), up1,
                 n * s_max, elems * src.element_size(),
                 build.stream_ptr(src))
    build.check(err, "reshard_pack")
    mode.count_launch("reshard_pack")
    return out
