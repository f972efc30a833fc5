"""Flash attention forward — wrapper of the hand-written CUDA kernel
`csrc/flash_attention.cu`.

Port of the Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`: blockwise
online-softmax attention with causal / sliding / chunked / bidir masks,
optional logit softcap, and GQA (query head h reads KV head h // (H/KVH)
without repeating KV). The CUDA kernel tiles by 64 and masks the ragged
edge itself, so it takes any S; ``block_q``/``block_k``, the TPU kernel's
tiling arguments, are checked only when a caller passes them, as the JAX
function checks them.
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
    if mode.on_cpu(q, k, v, kernel="flash_attention"):
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    out = torch.empty_like(q)
    _LAUNCH(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, s, d, d ** -0.5, KINDS[kind], window,
            chunk, 0.0 if softcap is None else float(softcap),
            int(softcap is not None), _DTYPES[q.dtype])
    mode.count_launch("flash_attention")
    return out
