"""Mamba-2 SSD chunk scan — wrapper of the hand-written CUDA kernel
`csrc/ssd_scan.cu`.

Port of the Pallas TPU kernel `repro/kernels/ssd_scan.py::ssd_scan`: the
chunked SSD scan over flattened batch·head rows from a zero state, in f32.
The CUDA kernel also writes the state after the last chunk (the carry the
TPU kernel keeps in VMEM scratch), which the prefill cache needs; ask for
it with ``final_state=True``. B and C may also come as (b, S, ds), shared
by the BH/b consecutive rows of one batch row (the model's ngroups = 1:
row bh reads B[bh // (BH/b)]), so they are not copied once per head.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, mode, ref

SMEM_LIMIT = 232_448      # bytes of shared memory one H100 block can use
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LAUNCH = build.Launcher("ssd_scan", "ssd_scan_launch", _ARGS)


def _f32(t):
    """f32, contiguous and 16-byte aligned (the kernel reads float4)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, final_state: bool = False):
    """x: (BH, S, hp); dt: (BH, S); A: (BH,); B, C: (BH, S, ds) or
    (b, S, ds) with BH % b == 0. Returns y (BH, S, hp) f32, and with
    ``final_state`` also the final state (BH, hp, ds) f32."""
    if x.ndim != 3 or dt.shape != x.shape[:2] or A.shape != x.shape[:1]:
        raise ValueError(
            f"ssd_scan: expected x (BH,S,hp), dt (BH,S), A (BH,), got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}"
        )
    bh, s, hp = x.shape
    if (B.ndim != 3 or C.shape != B.shape or B.shape[1] != s
            or B.shape[0] < 1 or bh % B.shape[0] != 0):
        raise ValueError(
            f"ssd_scan: B/C must be (BH,S,ds) or (b,S,ds) with BH % b == 0, "
            f"got {tuple(B.shape)} and {tuple(C.shape)} for x {tuple(x.shape)}"
        )
    ds = B.shape[-1]
    L = min(chunk, s)
    if L < 1 or s % L != 0:
        raise ValueError(
            f"ssd_scan: sequence length s={s} is not divisible by the "
            f"chunk length chunk={L}; pad the sequence or pass a chunk "
            f"that divides {s}"
        )
    if mode.on_cpu(x, dt, A, B, C, kernel="ssd_scan"):
        return ref.ssd_scan_ref(x, dt, A, B, C, final_state=final_state)
    if hp % 4 or ds % 8:
        raise ValueError(
            f"ssd_scan: the CUDA kernel takes hp % 4 == 0 and ds % 8 == 0, "
            f"got hp={hp}, ds={ds}"
        )
    smem = build.function("ssd_scan", "ssd_scan_smem_bytes",
                          [ctypes.c_int] * 3, restype=ctypes.c_longlong)(
        L, hp, ds)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan: chunk={L}, hp={hp}, ds={ds} need {smem} bytes of "
            f"shared memory per block, more than the card's {SMEM_LIMIT}"
        )
    x, dt, A, B, C = (_f32(t) for t in (x, dt, A, B, C))
    y = torch.empty((bh, s, hp), dtype=torch.float32, device=x.device)
    h = torch.empty((bh, hp, ds), dtype=torch.float32, device=x.device)
    _LAUNCH(x.get_device(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), h.data_ptr(), bh, s, L,
            hp, ds, bh // B.shape[0])
    mode.count_launch("ssd_scan")
    return (y, h) if final_state else y
