"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) — port of
`repro/models/ssm.py`.

A multi-token call from the zero state (the cache-less forward, and
`Model.prefill`, which fills the cache from position 0) runs the chunked
SSD scan through the hand-written `kernels.ssd_scan`, which also returns
the final state the cache keeps. A one-token call against a cache is the
O(1) recurrent update, plain PyTorch as in the reference. A multi-token
call that would continue from a cached (non-zero) state is reached by no
entry point — the serve engine feeds recurrent prompts one token at a
time — and raises. The gated RMSNorm runs `kernels.rmsnorm`.

The training forward (``plain=True``) computes the block as the
reference's forward does, in plain differentiable PyTorch: the scan is the
reference model's own chunked formulation `_ssd_chunked` (also the plain
version the kernel's outputs, y and the final state, are held against)
and the gated norm is `common.rms_norm`.

Layout as in the reference: d_inner channels are nh contiguous SSD heads
of hp channels; B/C are one group (ngroups = 1) shared by every head of a
batch row. Caches are updated in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.common import P, dense_init, rms_norm, softplus


def ssm_init(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    s = cfg.ssm
    d, di, ds, nh = cfg.d_model, s.d_inner(cfg.d_model), s.d_state, \
        s.n_heads(cfg.d_model)
    dev = gen.device
    p = {
        "w_z": dense_init(gen, (d, di), d, dtype),
        "w_x": dense_init(gen, (d, di), d, dtype),
        "w_B": dense_init(gen, (d, ds), d, dtype),
        "w_C": dense_init(gen, (d, ds), d, dtype),
        "w_dt": dense_init(gen, (d, nh), d, dtype),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=dev),
        "conv_w": dense_init(gen, (s.d_conv, di + 2 * ds), s.d_conv, dtype),
        "conv_b": torch.zeros(di + 2 * ds, dtype=dtype, device=dev),
    }
    a = torch.rand(nh, generator=gen, device=dev, dtype=torch.float32)
    p["A_log"] = torch.log(1.0 + 15.0 * a)          # A = -U(1, 16)
    p["D"] = torch.ones(nh, dtype=torch.float32, device=dev)
    p["norm"] = torch.ones(di, dtype=dtype, device=dev)
    p["w_out"] = dense_init(gen, (di, d), di, dtype)
    return p


def ssm_specs(cfg: ArchConfig, tp: str = "model") -> dict:
    return {
        "w_z": P(None, tp),
        "w_x": P(None, tp),
        "w_B": P(None, None),
        "w_C": P(None, None),
        "w_dt": P(None, tp),
        "dt_bias": P(tp),
        "conv_w": P(None, None),  # mixed di+2ds channels; small — replicate
        "conv_b": P(None),
        "A_log": P(tp),
        "D": P(tp),
        "norm": P(tp),
        "w_out": P(tp, None),
    }


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d. xBC: (B,S,C); conv_w: (K,C).
    conv_state: (B,K-1,C) tail of previous tokens (decode) or None (from
    the zero state). Returns (silu(conv + b), new tail)."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xBC.new_zeros((xBC.shape[0], k - 1, xBC.shape[2]))
    else:
        pad = conv_state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)              # (B, S+K-1, C)
    s = xBC.shape[1]
    out = sum(full[:, i:i + s, :] * conv_w[i] for i in range(k))
    return F.silu(out + conv_b), full[:, -(k - 1):, :]


def _ssd_chunked(x, dt, A, B, C, h0, chunk: int):
    """The reference model's chunked SSD scan, plain PyTorch.

    x: (B,S,nh,hp)  dt: (B,S,nh)  A: (nh,)<0  B,C: (B,S,ds)
    h0: (B,nh,hp,ds) initial state. Returns y (B,S,nh,hp), h_final.
    """
    b, s, nh, hp = x.shape
    ds = B.shape[-1]
    L = min(chunk, s)
    if s % L != 0:
        raise ValueError(
            f"_ssd_chunked: sequence length s={s} is not divisible by the "
            f"chunk length chunk={L}"
        )
    nc = s // L
    xr = x.reshape(b, nc, L, nh, hp)
    dtr = dt.reshape(b, nc, L, nh)
    Br = B.reshape(b, nc, L, ds)
    Cr = C.reshape(b, nc, L, ds)

    a = dtr * A                                       # (b,nc,L,nh) <= 0
    acum = torch.cumsum(a, dim=2)                     # inclusive
    atot = acum[:, :, -1, :]                          # (b,nc,nh)

    G = torch.einsum("bcis,bcjs->bcij", Cr, Br)       # (b,nc,L,L)
    decay = torch.exp(torch.clamp(
        acum[:, :, :, None, :] - acum[:, :, None, :, :], -60.0, 0.0))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    M = G[..., None] * decay * mask[None, None, :, :, None]
    M = M * dtr[:, :, None, :, :]                     # weight by dt_j
    y_diag = torch.einsum("bcijn,bcjnp->bcinp", M, xr)

    w = torch.exp(torch.clamp(atot[:, :, None, :] - acum, -60.0, 0.0)) * dtr
    chunk_state = torch.einsum("bcjn,bcjs,bcjnp->bcnps", w, Br, xr)

    h, h_prevs = h0, []
    for c in range(nc):                               # PRE-chunk states
        h_prevs.append(h)
        h = h * torch.exp(atot[:, c])[:, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)             # (b,nc,nh,hp,ds)
    cdec = torch.exp(torch.clamp(acum, -60.0, 0.0))   # (b,nc,L,nh)
    y_off = torch.einsum("bcis,bcnps,bcin->bcinp", Cr, h_prevs, cdec)
    return (y_diag + y_off).reshape(b, s, nh, hp), h


def scan_inputs(cfg: ArchConfig, p: dict, x, conv_state=None):
    """What the SSD scan of the block input ``x`` (B,S,d) takes: returns
    the gate z (B,S,di), x (B,S,nh,hp), dt (B,S,nh), A (nh,) < 0, B and C
    (B,S,ds), all but z in f32, and the conv tail after ``x``
    (``conv_state``: the tail before it, or None for the zero state)."""
    s = cfg.ssm
    b, S, d = x.shape
    di, ds = s.d_inner(d), s.d_state
    z = x @ p["w_z"]
    xi = x @ p["w_x"]
    Bp = x @ p["w_B"]
    Cp = x @ p["w_C"]
    dt = softplus((x @ p["w_dt"]).float() + p["dt_bias"])

    xBC = torch.cat([xi, Bp, Cp], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xi, Bp, Cp = torch.split(xBC, [di, ds, ds], dim=-1)
    xh = xi.reshape(b, S, s.n_heads(d), s.head_dim).float()
    A = -torch.exp(p["A_log"])
    return z, xh, dt, A, Bp.float(), Cp.float(), new_conv


def ssm_apply(
    cfg: ArchConfig,
    p: dict,
    x,
    *,
    cache: Optional[dict] = None,   # {'conv','h'}, written in place
    cache_pos=None,                 # prefill: 0; decode: any
    plain: bool = False,            # the training route: plain ops, no cache
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (out, cache). cache: {'conv': (B,K-1,di+2ds), 'h':
    (B,nh,hp,ds) f32}. ``plain``: the cache-less training forward in
    plain PyTorch (`_ssd_chunked`, `common.rms_norm`)."""
    s = cfg.ssm
    b, S, d = x.shape
    di, ds = s.d_inner(d), s.d_state
    nh, hp = s.n_heads(d), s.head_dim
    decode = cache is not None and S == 1
    if cache is not None and not decode and not (
            isinstance(cache_pos, int) and cache_pos == 0):
        raise ValueError(
            f"ssm_apply: a {S}-token call continuing from a cached state "
            f"(cache_pos={cache_pos!r}) is not supported: the SSD scan runs "
            "from the zero state (prefill at position 0); feed later tokens "
            "one at a time"
        )

    z, xh, dt, A, Bf, Cf, new_conv = scan_inputs(
        cfg, p, x, cache["conv"] if decode else None)

    if decode:
        # recurrent decode: h' = exp(dt A) h + dt B x ; y = C·h'
        dt1 = dt[:, 0]                                # (b,nh)
        da = torch.exp(dt1 * A)
        inj = torch.einsum("bn,bs,bnp->bnps", dt1, Bf[:, 0], xh[:, 0])
        h_new = cache["h"] * da[:, :, None, None] + inj
        y = torch.einsum("bs,bnps->bnp", Cf[:, 0], h_new)[:, None]
    elif plain:
        y, h_new = _ssd_chunked(xh, dt, A, Bf, Cf,
                                xh.new_zeros((b, nh, hp, ds)), s.chunk)
    else:
        # (b·nh, S, ·) rows; B/C stay (b, S, ds), shared by a row's heads
        y, h_new = ssd_scan(
            xh.permute(0, 2, 1, 3).reshape(b * nh, S, hp),
            dt.permute(0, 2, 1).reshape(b * nh, S),
            A.repeat(b), Bf, Cf, chunk=s.chunk, final_state=True,
        )
        y = y.reshape(b, nh, S, hp).permute(0, 2, 1, 3)
        h_new = h_new.reshape(b, nh, hp, ds)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_new)

    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(b, S, di).to(x.dtype) * F.silu(z)
    # gated RMSNorm (mamba2): norm(y * silu(z)), one kernel row per token
    if plain:
        y = rms_norm(y, p["norm"], cfg.norm_eps)
    else:
        y = rmsnorm(y.reshape(b * S, di), p["norm"],
                    eps=cfg.norm_eps).reshape(b, S, di)
    return y @ p["w_out"], cache


def init_ssm_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                   device) -> dict:
    """SSD state of ``n_layers`` layers, stacked on a leading layer axis:
    conv (n_layers, batch, K-1, di+2ds) in ``dtype``, h (n_layers, batch,
    nh, hp, ds) f32."""
    s = cfg.ssm
    d = cfg.d_model
    di, ds, nh, hp = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    return {
        "conv": torch.zeros((n_layers, batch, s.d_conv - 1, di + 2 * ds),
                            dtype=dtype, device=device),
        "h": torch.zeros((n_layers, batch, nh, hp, ds), dtype=torch.float32,
                         device=device),
    }
