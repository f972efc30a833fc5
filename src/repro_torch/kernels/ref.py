"""Plain PyTorch versions of the hand-written kernels (port of
`repro/kernels/ref.py`). The kernel wrappers run these for CPU tensors; the
tests and `chip_smoke.py` hold the CUDA kernels against them."""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(q, k, v, *, kind: str = "causal", window: int = 4096,
                        chunk: int = 8192, softcap: Optional[float] = None):
    """q: (B,H,S,D); k/v: (B,KVH,S,D)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    ok = kp <= qp
    if kind == "sliding":
        ok &= kp > qp - window
    elif kind == "chunked":
        ok &= (kp // chunk) == (qp // chunk)
    elif kind == "bidir":
        ok = torch.ones_like(ok)
    scores = scores.masked_fill(~ok[None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def rmsnorm_ref(x, w, *, eps: float = 1e-6, plus_one: bool = False):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w32 = w.float()
    if plus_one:
        w32 = 1.0 + w32
    return (y * w32).to(x.dtype)


def ssd_scan_ref(x, dt, A, B, C, *, final_state: bool = False):
    """Sequential SSD recurrence (exact), from a zero state, in f32.
    x: (BH,S,hp); dt: (BH,S); A: (BH,); B/C: (BH,S,ds), or (b,S,ds) shared
    by BH/b consecutive rows (row bh reads B[bh // (BH/b)]). Returns y
    (BH,S,hp), and the final state (BH,hp,ds) when ``final_state``."""
    x, dt, A = x.float(), dt.float(), A.float()
    bh, s, hp = x.shape
    rep = bh // B.shape[0]
    B = B.float().repeat_interleave(rep, dim=0)
    C = C.float().repeat_interleave(rep, dim=0)
    h = x.new_zeros((bh, hp, B.shape[-1]))
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t] * A)[:, None, None] * h + (
            dt[:, t, None, None] * torch.einsum("bp,bs->bps", x[:, t], B[:, t])
        )
        ys.append(torch.einsum("bps,bs->bp", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bh, 0, hp))
    return (y, h) if final_state else y


def reshard_pack_ref(src, send_idx):
    """src: (U+1, elems) zero-padded; send_idx: (n, s_max)."""
    return src[send_idx.long()]


def reshard_pack_ranks_ref(xp, send_idx):
    """xp: (R, U+1, elems) zero-padded; send_idx: (R, n, s_max) → (R, n,
    s_max, elems), rank r gathering from xp[r]: one advanced index."""
    ranks = torch.arange(xp.shape[0], device=xp.device)[:, None, None]
    return xp[ranks, send_idx.long()]


def bucket_pack_ref(leaves):
    """Column concat of same-row leaves — the per-leaf column-slice copy of
    the Pallas body (`repro/kernels/bucket.py::_pack_kernel`)."""
    leaves = tuple(leaves)
    if len(leaves) == 1:
        return leaves[0]
    rows = leaves[0].shape[0]
    out = leaves[0].new_empty((rows, sum(x.shape[1] for x in leaves)))
    off = 0
    for x in leaves:
        out[:, off:off + x.shape[1]] = x
        off += x.shape[1]
    return out


def bucket_unpack_ref(flat, widths):
    """Static column slices of a bucket, each copied into its own tensor
    (`_unpack_kernel`)."""
    out, off = [], 0
    for w in widths:
        out.append(flat[:, off:off + w].clone())
        off += w
    return tuple(out)
