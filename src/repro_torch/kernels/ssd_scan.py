"""Mamba-2 SSD chunk scan — wrapper of the hand-written CUDA kernels
`csrc/ssd_scan.cu`.

Port of the Pallas TPU kernel `repro/kernels/ssd_scan.py::ssd_scan`: the
chunked SSD scan over flattened batch·head rows from a zero state, in f32.
The CUDA kernels also write the state after the last chunk (the carry the
TPU kernel keeps in VMEM scratch), which the prefill cache needs; ask for
it with ``final_state=True``. B and C may also come as (b, S, ds), shared
by the BH/b consecutive rows of one batch row (the model's ngroups = 1:
row bh reads B[bh // (BH/b)]), so they are not copied once per head.

One call issues four kernels on the current stream (`csrc/ssd_scan.cu`):
(a) C·Bᵀ once per (B/C row, chunk) and each chunk's cumsum, (b) each
chunk's own state contribution, (c) the state passed over the chunks in
order, (d) the output. It is one counted launch. `grids`, `cb_pairs`,
`cb_tile` and `out_tile` mirror how the kernels cut the work into blocks,
for the tests.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, mode, ref

TILE = 64        # rows, columns and depth of a product tile (kT)
DEPTH = 32       # ds depth of one step of (a)'s C·Bᵀ (kS)
PASS_TILE = 32   # (c) works on PASS_TILE x PASS_TILE (ds, hp) tiles (kPT)
CHAINS = 4       # cumsum chains of one block of (a): a warp each
_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LAUNCH = build.Launcher("ssd_scan", "ssd_scan_launch", _ARGS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grids(bh: int, groups: int, s: int, L: int, hp: int,
          ds: int) -> Dict[str, Tuple[int, ...]]:
    """The grid of each kernel of one call: (a) ``cb`` one block per causal
    (row tile, column tile) pair of each (B/C row, chunk) (`cb_pairs`),
    then blocks of CHAINS cumsum chains, one per (row, chunk); (b)
    ``state`` (row·chunk, ds tile, hp tile); (c) ``pass`` (row, ds tile,
    hp tile) of PASS_TILE-wide tiles; (d) ``out`` (row·chunk·row tile, hp
    tile)."""
    nc, nt = s // L, _cdiv(L, TILE)
    return {"cb": (cb_pairs(groups, nc, nt) + _cdiv(bh * nc, CHAINS),),
            "state": (bh * nc, _cdiv(ds, TILE), _cdiv(hp, TILE)),
            "pass": (bh, _cdiv(ds, PASS_TILE), _cdiv(hp, PASS_TILE)),
            "out": (bh * nc * nt, _cdiv(hp, TILE))}


def cb_pairs(groups: int, nc: int, nt: int) -> int:
    """Blocks of kernel (a) that compute C·Bᵀ tiles; block ``cb_pairs + k``
    computes the cumsum of chains (row·nc + chunk) k·CHAINS .. k·CHAINS +
    CHAINS - 1, a warp each."""
    return groups * nc * nt * (nt + 1) // 2


def cb_tile(block: int, nc: int, nt: int) -> Tuple[int, int, int, int]:
    """(B/C row, chunk, row tile, column tile ≤ row tile) of block
    ``block`` of kernel (a) (``cb_kernel``'s decode)."""
    pairs = nt * (nt + 1) // 2
    gc, pair = divmod(block, pairs)
    it = int(((8 * pair + 1) ** 0.5 - 1) / 2)
    while (it + 1) * (it + 2) // 2 <= pair:
        it += 1
    while it * (it + 1) // 2 > pair:
        it -= 1
    return gc // nc, gc % nc, it, pair - it * (it + 1) // 2


def out_tile(block: int, nc: int, nt: int) -> Tuple[int, int, int]:
    """(row, chunk, row tile) of block ``block`` of kernel (d)
    (``out_kernel``'s decode: a chunk's longest tiles first)."""
    rc, k = divmod(block, nt)
    return rc // nc, rc % nc, nt - 1 - k


def _f32(t):
    """f32, contiguous and 16-byte aligned (the kernels read float4)."""
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
    groups, ds = B.shape[0], B.shape[-1]
    L = min(chunk, s)
    if L < 1 or s % L != 0:
        raise ValueError(
            f"ssd_scan: sequence length s={s} is not divisible by the "
            f"chunk length chunk={L}; pad the sequence or pass a chunk "
            f"that divides {s}"
        )
    if mode.on_cpu(x, dt, A, B, C, kernel="ssd_scan"):
        return ref.ssd_scan_ref(x, dt, A, B, C, final_state=final_state)
    mode.check_forward_only(x, dt, A, B, C, kernel="ssd_scan")
    dev = x.device
    if 0 in (bh, hp, ds):                     # nothing to scan: y = 0
        y = torch.zeros((bh, s, hp), dtype=torch.float32, device=dev)
        h = torch.zeros((bh, hp, ds), dtype=torch.float32, device=dev)
        return (y, h) if final_state else y
    x, dt, A, B, C = (_f32(t) for t in (x, dt, A, B, C))
    nc = s // L
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((bh, s, hp), **f32)
    h = torch.empty((bh, hp, ds), **f32)
    acum = torch.empty((bh, s), **f32)
    gt = torch.empty((groups, nc, L, L), **f32)
    ct = torch.empty((groups, nc, ds, L), **f32)
    st = torch.empty((bh, nc, ds, hp), **f32)
    _LAUNCH(x.get_device(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), h.data_ptr(),
            acum.data_ptr(), gt.data_ptr(), ct.data_ptr(), st.data_ptr(), bh,
            s, L, hp, ds, groups)
    mode.count_launch("ssd_scan")
    return (y, h) if final_state else y
