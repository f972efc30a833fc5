"""RMSNorm — wrapper of the hand-written CUDA kernel `csrc/rmsnorm.cu`.

Port of the Pallas TPU kernel `repro/kernels/rmsnorm.py::rmsnorm`: row-wise
``x·rsqrt(mean(x²)+eps)·w`` (``(1+w)`` when ``plus_one``), computed in f32
and returned in ``x.dtype``. The CUDA kernel runs one block per row, so
it takes any row count; ``block_rows``, the TPU kernel's row-block
argument, is checked only when a caller passes it, as the JAX function
checks it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, mode, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


def rmsnorm(x, w, *, eps: float = 1e-6, plus_one: bool = False,
            block_rows: Optional[int] = None):
    """x: (N, d); w: (d,). Returns (N, d) in x.dtype."""
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(
            f"rmsnorm: expected x (N, d) and w (d,), got {tuple(x.shape)} "
            f"and {tuple(w.shape)}"
        )
    n, d = x.shape
    br = n if block_rows is None else min(block_rows, n)
    if br < 1 or n % br != 0:
        raise ValueError(
            f"rmsnorm: row count n={n} is not divisible by the row-block "
            f"size block_rows={br}; pad the rows or pass a block_rows that "
            f"divides {n}"
        )
    if mode.on_cpu(x, w, kernel="rmsnorm"):
        return ref.rmsnorm_ref(x, w, eps=eps, plus_one=plus_one)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(
            f"rmsnorm: the CUDA kernel takes f32 or bf16 x with w of the "
            f"same type, got x {x.dtype} and w {w.dtype}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    y = torch.empty_like(x)
    fn = build.function("rmsnorm", "rmsnorm_launch", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d, eps,
                 int(plus_one), _DTYPES[x.dtype], build.stream_ptr(x))
    build.check(err, "rmsnorm")
    mode.count_launch("rmsnorm")
    return y
