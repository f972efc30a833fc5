"""Flash attention forward — wrapper of the hand-written CUDA kernel
`csrc/flash_attention.cu`.

Port of the Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`: blockwise
online-softmax attention with causal / sliding / chunked / bidir masks,
optional logit softcap, and GQA (query head h reads KV head h // (H/KVH)
without repeating KV). The CUDA kernel packs the G = H/KVH query heads of
a KV head into one block's rows, position-major (row r is position r // G
of head r % G), in q tiles of the rows `tiling` gives, loops over K/V
tiles and masks the ragged edges itself, so it takes any S;
``block_q``/``block_k``, the TPU kernel's tiling arguments, are checked
only when a caller passes them, as the JAX function checks them. bf16
runs on the tensor cores (P rounded to bf16 before P·V), f32 exactly on
the CUDA cores.

`tiling`, `tile_dead`, `tile_full` and `live_tiles` mirror the kernel's
blocking and tile predicates on the host, for the tests.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, mode, ref

KINDS = {"causal": 0, "sliding": 1, "chunked": 2, "bidir": 3}
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2
         + [ctypes.c_void_p])
_LAUNCH = build.Launcher("flash_attention", "flash_attention_launch", _ARGS)

SMS = 132   # streaming multiprocessors of an H100


def tiling(b: int, h: int, kvh: int, s: int, d: int, bf16: bool):
    """(rows of a q tile, keys of a K/V tile, m16 row tiles a warp) the
    kernel launches with, as its ``launch_d`` chooses: f32 takes 64-row
    tiles; bf16 takes 128-row tiles (two m16 tiles a warp) when that still
    gives every SM two blocks and d < 256, else 64-row ones. K/V tiles are
    64 keys, 32 at d = 256."""
    bk = 32 if d == 256 else 64
    if not bf16:
        return 64, bk, 1
    mt = 2 if d != 256 and b * kvh * ((h // kvh) * s // 128) >= 2 * SMS else 1
    return 64 * mt, bk, mt


def tile_dead(kind, window, chunk, q_lo, q_hi, k_lo, k_hi) -> bool:
    """True when no (q, k) with q in [q_lo, q_hi], k in [k_lo, k_hi] is
    allowed (the kernel's ``tile_dead``)."""
    if kind == "bidir":
        return False
    if k_lo > q_hi:
        return True
    if kind == "sliding" and k_hi <= q_lo - window:
        return True
    if kind == "chunked" and k_hi // chunk < q_lo // chunk:
        return True
    return False


def tile_full(kind, window, chunk, q_lo, q_hi, k_lo, k_hi) -> bool:
    """True when every such pair is allowed (the kernel's ``tile_full``)."""
    if kind == "bidir":
        return True
    if k_hi > q_lo:
        return False
    if kind == "sliding":
        return k_lo > q_hi - window
    if kind == "chunked":
        return k_lo // chunk == q_hi // chunk
    return True


def live_tiles(kind, window, chunk, q_lo, q_hi, s, bk):
    """The k tiles [kt0, kt1) a q tile over positions [q_lo, q_hi] visits:
    dead tiles trimmed from both ends, as the kernel's ``block_tile``."""
    nk = -(-s // bk)

    def dead(kt):
        return tile_dead(kind, window, chunk, q_lo, q_hi, kt * bk,
                         min(kt * bk + bk, s) - 1)

    kt0, kt1 = 0, nk
    while kt0 < kt1 and dead(kt0):
        kt0 += 1
    while kt1 > kt0 and dead(kt1 - 1):
        kt1 -= 1
    return kt0, kt1


def allowed_pairs(kind: str, s: int, window: int = 4096,
                  chunk: int = 8192) -> int:
    """The (query, key) pairs of one head over ``s`` positions that the
    mask ``kind`` allows: key k <= query q (causal), and also k > q -
    window (sliding) or k // chunk == q // chunk (chunked); all s² for
    bidir."""
    def tri(n):
        return n * (n + 1) // 2

    if kind == "bidir":
        return s * s
    if kind == "sliding" and window < s:
        return tri(window) + (s - window) * window
    if kind == "chunked" and chunk < s:
        return (s // chunk) * tri(chunk) + tri(s % chunk)
    return tri(s)


def flash_attention_cost(b: int, h: int, kvh: int, s: int, d: int,
                         itemsize: int, kind: str = "causal",
                         window: int = 4096,
                         chunk: int = 8192) -> mode.Cost:
    """One call: q and the output (B, H, S, D) and k/v (B, KVH, S, D)
    moved once each; 4·D operations (Q·Kᵀ and P·V, a multiply and an add
    each) for every allowed (query, key) pair of every query head."""
    return mode.Cost(4 * d * allowed_pairs(kind, s, window, chunk) * b * h,
                     (2 * b * h * s * d + 2 * b * kvh * s * d) * itemsize)


def flash_attention(
    q, k, v, *,
    kind: str = "causal",          # causal | sliding | chunked | bidir
    window: int = 4096,
    chunk: int = 8192,
    softcap: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """q: (B, H, S, D); k/v: (B, KVH, S, D) with H % KVH == 0.
    Returns (B, H, S, D) in q.dtype."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: expected q (B,H,S,D) and k/v (B,KVH,S,D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if k.shape != (b, kvh, s, d) or kvh < 1 or h % kvh != 0:
        raise ValueError(
            f"flash_attention: k/v shape {tuple(k.shape)} does not match q "
            f"{tuple(q.shape)} with H % KVH == 0"
        )
    if kind not in KINDS:
        raise ValueError(f"flash_attention: unknown mask kind {kind!r}")
    if chunk < 1:
        raise ValueError(f"flash_attention: chunk={chunk} must be >= 1")
    bq = s if block_q is None else min(block_q, s)
    bk = s if block_k is None else min(block_k, s)
    if s % bq != 0:
        raise ValueError(
            f"flash_attention: sequence length s={s} is not divisible by the "
            f"query-block size block_q={bq}; pad the sequence or pass a "
            f"block_q that divides {s}"
        )
    if s % bk != 0:
        raise ValueError(
            f"flash_attention: sequence length s={s} is not divisible by the "
            f"key-block size block_k={bk}; pad the sequence or pass a "
            f"block_k that divides {s}"
        )
    where = mode.device_kind(q, k, v, kernel="flash_attention")
    if where == "cpu":
        return ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                       chunk=chunk, softcap=softcap)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: the CUDA kernel takes f32 or bf16 q/k/v of "
            f"one type, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: the CUDA kernel takes head_dim in "
            f"{HEAD_DIMS}, got d={d}"
        )
    if where == "meta":
        mode.count_dry("flash_attention", flash_attention_cost(
            b, h, kvh, s, d, q.element_size(), kind, window, chunk))
        return torch.empty_like(q)
    mode.check_forward_only(q, k, v, kernel="flash_attention")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    out = torch.empty_like(q)
    _LAUNCH(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, s, d, d ** -0.5, KINDS[kind], window,
            chunk, 0.0 if softcap is None else float(softcap),
            int(softcap is not None), _DTYPES[q.dtype])
    mode.count_launch("flash_attention", kind)
    return out
