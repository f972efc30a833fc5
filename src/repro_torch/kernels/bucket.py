"""Gradient-bucket pack/unpack — wrappers of the hand-written CUDA kernel
`csrc/bucket.cu`.

Port of the Pallas TPU kernels `repro/kernels/bucket.py::bucket_pack` and
`::bucket_unpack`: the overlapped gradient sync (`core.overlap`) fuses every
leaf that shares a reshard plan into ONE flat ``(rows, Σwidths)`` buffer
before the sync, each leaf's flattened payload in its own contiguous column
range, and splits it back afterwards. Rows are shared by construction (the
Algorithm-1 tables index unit rows only), so the fused buffer reshards
under the per-leaf tables unchanged.

Both wrappers keep the reference's contract: a `ValueError` for no leaves,
non-2-D leaves, mismatched rows or dtype, and widths that do not sum to the
total; a single leaf passes through with no launch. Each call with two or
more leaves is one kernel launch (one per `kMaxLeaves` leaves beyond that).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build, mode, ref

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p]
_LAUNCH = build.Launcher("bucket", "bucket_copy_launch", _ARGS)
_max_leaves = 0  # the kernel's kMaxLeaves, read at the first launch


def _launch(pack: bool, leaves: Sequence[torch.Tensor], flat: torch.Tensor,
            kernel: str) -> None:
    """One `bucket_copy_launch` per group of at most `kMaxLeaves` leaves;
    each group's first column is folded into the flat pointer."""
    global _max_leaves
    if not _max_leaves:
        _max_leaves = build.function("bucket", "bucket_max_leaves", [])()
    max_leaves = _max_leaves
    rows = flat.shape[0]
    pitch = flat.shape[1] * flat.element_size()
    col = 0
    for lo in range(0, len(leaves), max_leaves):
        group = leaves[lo:lo + max_leaves]
        n = len(group)
        ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in group])
        widths = (ctypes.c_longlong * n)(
            *[t.shape[1] * t.element_size() for t in group])
        _LAUNCH(flat.get_device(), int(pack), ptrs, widths, n,
                flat.data_ptr() + col, rows, pitch)
        mode.count_launch(kernel)
        col += sum(widths)


def bucket_pack(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fuse 2-D leaves ``(rows, w_i)`` (same rows, same dtype) into one
    ``(rows, Σw_i)`` bucket. A single leaf passes through unchanged (no
    kernel launch — nothing to fuse)."""
    leaves = tuple(leaves)
    if not leaves:
        raise ValueError("bucket_pack needs at least one leaf")
    rows = leaves[0].shape[0]
    dtype = leaves[0].dtype
    for x in leaves:
        if x.ndim != 2 or x.shape[0] != rows or x.dtype != dtype:
            raise ValueError(
                f"bucket leaves must be 2-D (rows={rows}, w) of {dtype}; got "
                f"{[(tuple(t.shape), str(t.dtype)) for t in leaves]}"
            )
    if len(leaves) == 1:
        return leaves[0]
    if mode.on_cpu(*leaves, kernel="bucket_pack"):
        return ref.bucket_pack_ref(leaves)
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError("bucket_pack: leaves must be contiguous")
    total = sum(x.shape[1] for x in leaves)
    out = torch.empty((rows, total), dtype=dtype, device=leaves[0].device)
    _launch(True, leaves, out, "bucket_pack")
    return out


def bucket_unpack(flat: torch.Tensor,
                  widths: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
    """Split a ``(rows, Σwidths)`` bucket back into per-leaf ``(rows, w_i)``
    tensors — the exact inverse of `bucket_pack` (same static offsets).
    Returns a tuple, one tensor per width; each owns its storage."""
    widths = tuple(int(w) for w in widths)
    if flat.ndim != 2:
        raise ValueError(
            f"bucket_unpack: expected a 2-D (rows, total) bucket, got "
            f"{tuple(flat.shape)}"
        )
    rows, total = flat.shape
    if sum(widths) != total:
        raise ValueError(f"widths {widths} do not sum to {total}")
    if len(widths) == 1:
        return (flat,)
    if mode.on_cpu(flat, kernel="bucket_unpack"):
        return ref.bucket_unpack_ref(flat, widths)
    if not flat.is_contiguous():
        raise ValueError("bucket_unpack: the bucket must be contiguous")
    outs = tuple(torch.empty((rows, w), dtype=flat.dtype, device=flat.device)
                 for w in widths)
    _launch(False, outs, flat, "bucket_unpack")
    return outs
