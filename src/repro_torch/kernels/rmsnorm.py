"""RMSNorm — wrapper of the hand-written CUDA kernel `csrc/rmsnorm.cu`.

Port of the Pallas TPU kernel `repro/kernels/rmsnorm.py::rmsnorm`: row-wise
``x·rsqrt(mean(x²)+eps)·w`` (``(1+w)`` when ``plus_one``), computed in f32
and returned in ``x.dtype``. The CUDA kernel takes any row count;
``block_rows``, the TPU kernel's row-block argument, is checked only when a
caller passes it, as the JAX function checks it. How a row is split over
threads is `launch_config`'s choice, made here and passed to the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import build, mode, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p]
_LAUNCH = build.Launcher("rmsnorm", "rmsnorm_launch", _ARGS)

MAX_WORDS = 4          # words a thread keeps in registers (kMaxWords)
MAX_TPR = 1024         # threads per row at most (and of the loop path)
WORD_BYTES = 16


class LaunchConfig(NamedTuple):
    """How the kernel covers a row of d elements: ``vec`` elements per word
    (one 16-byte load, or 1 on the scalar path), ``tpr`` threads per row,
    and ``words_per_thread`` words each thread keeps in registers — thread
    t holds words t, t + tpr, ... — or 0 on the loop path (the row too wide
    for registers, read twice by ``tpr`` threads striding over it)."""

    vec: int
    tpr: int
    words_per_thread: int


def launch_config(d: int, itemsize: int, aligned: bool) -> LaunchConfig:
    """The kernel's split of a row of ``d`` elements of ``itemsize`` bytes:
    16-byte words when ``aligned`` (every pointer on a 16-byte boundary) and
    the word divides ``d``, else single elements; then the fewest threads
    per row (a power of two from a warp up) that keep the row in registers
    at `MAX_WORDS` words each, or the loop path beyond ``MAX_TPR`` threads."""
    vec = WORD_BYTES // itemsize
    if not aligned or d % vec:
        vec = 1
    words = d // vec
    tpr = 32
    while tpr * MAX_WORDS < words and tpr < MAX_TPR:
        tpr *= 2
    if tpr * MAX_WORDS < words:
        return LaunchConfig(vec, MAX_TPR, 0)
    return LaunchConfig(vec, tpr, -(-words // tpr))


class Params(ctypes.Structure):
    """The launch's fixed arguments (`rmsnorm.cu`'s ``Params``), built once
    per (d, dtype, plus_one, eps, alignment) and passed by address."""

    _fields_ = [("d", ctypes.c_int), ("eps", ctypes.c_float),
                ("plus_one", ctypes.c_int), ("dtype", ctypes.c_int),
                ("vec", ctypes.c_int), ("tpr", ctypes.c_int),
                ("words_per_thread", ctypes.c_int)]


def rmsnorm_cost(n: int, d: int, itemsize: int) -> mode.Cost:
    """One call on ``n`` rows of ``d`` elements of ``itemsize`` bytes: x
    read and y written once, w read once; four operations an element
    (square, sum, scale, weight)."""
    return mode.Cost(4 * n * d, (2 * n * d + d) * itemsize)


_params: Dict[tuple, Params] = {}
_addresses: Dict[tuple, int] = {}


def _params_address(key) -> int:
    """The address of the `Params` for ``key`` = (x dtype, w dtype, d,
    plus_one, eps, aligned), made at its first use; raises for a dtype the
    kernel does not take."""
    xdt, wdt, d, plus_one, eps, aligned = key
    if xdt not in _DTYPES or wdt != xdt:
        raise ValueError(
            f"rmsnorm: the CUDA kernel takes f32 or bf16 x with w of the "
            f"same type, got x {xdt} and w {wdt}"
        )
    cfg = launch_config(d, xdt.itemsize, aligned)
    _params[key] = Params(d, eps, int(plus_one), _DTYPES[xdt], *cfg)
    _addresses[key] = ctypes.addressof(_params[key])
    return _addresses[key]


def rmsnorm(x, w, *, eps: float = 1e-6, plus_one: bool = False,
            block_rows: Optional[int] = None):
    """x: (N, d); w: (d,). Returns (N, d) in x.dtype."""
    shape = x.shape
    if len(shape) != 2 or w.shape != shape[1:]:
        raise ValueError(
            f"rmsnorm: expected x (N, d) and w (d,), got {tuple(x.shape)} "
            f"and {tuple(w.shape)}"
        )
    n, d = shape
    if block_rows is not None or n < 1:
        br = n if block_rows is None else min(block_rows, n)
        if br < 1 or n % br != 0:
            raise ValueError(
                f"rmsnorm: row count n={n} is not divisible by the row-block "
                f"size block_rows={br}; pad the rows or pass a block_rows "
                f"that divides {n}"
            )
    where = mode.device_kind(x, w, kernel="rmsnorm")
    if where == "cpu":
        return ref.rmsnorm_ref(x, w, eps=eps, plus_one=plus_one)
    if where == "meta":
        if x.dtype not in _DTYPES or w.dtype != x.dtype:
            _params_address((x.dtype, w.dtype, d, plus_one, eps, True))
        mode.count_dry("rmsnorm", rmsnorm_cost(n, d, x.element_size()))
        return torch.empty_like(x)
    mode.check_forward_only(x, w, kernel="rmsnorm")
    xp, wp = x.data_ptr(), w.data_ptr()
    # y comes from the caching allocator, whose blocks are 512-byte aligned
    key = (x.dtype, w.dtype, d, plus_one, eps, not (xp | wp) % WORD_BYTES)
    params = _addresses.get(key) or _params_address(key)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    y = torch.empty_like(x)
    _LAUNCH(x.get_device(), xp, wp, y.data_ptr(), n, params)
    mode.count_launch("rmsnorm")
    return y
