"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) —
port of `repro/models/rglru.py`.

The recurrence h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t) is
diagonal. A one-token call against a cache is the O(1) update; a longer
call runs the linear recurrence as a log-depth (Hillis-Steele) prefix scan
from the zero state, or from the cached state folded in as
``b_sc + a_sc · h0``, as the reference's `lax.associative_scan` does. The
reference computes the block as plain jnp (no Pallas kernel), so the port
computes it as plain PyTorch. The causal conv is the SSD block's
(`models.ssm._causal_conv`, with its SiLU), as the reference reuses it.

Layout as in the reference: d_inner channels in ``nb = d_inner /
block_width`` blocks, each with its own (w, w) gate projections — the
block is the NTP partition unit of the state (`reshard.units`). ``lam``,
``bias_a`` and ``bias_i`` stay f32. Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import P, dense_init, softplus
from repro_torch.models.ssm import _causal_conv

_C = 8.0  # Griffin's fixed recurrence sharpness


def rglru_init(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    g = cfg.rglru
    d = cfg.d_model
    di = g.d_inner(d)
    nb, w = di // g.block_width, g.block_width
    dev = gen.device
    # Λ so that a = sigmoid(Λ)^c lands in [0.9, 0.999] (Griffin app. A)
    u = torch.rand(di, generator=gen, device=dev, dtype=torch.float32)
    u = 0.9 + (0.999 - 0.9) * u
    lam = torch.log(torch.exp(-torch.log(u) / _C) - 1.0)  # softplus⁻¹(−log u / c)
    return {
        "w_x": dense_init(gen, (d, di), d, dtype),
        "w_y": dense_init(gen, (d, di), d, dtype),
        "conv_w": dense_init(gen, (g.d_conv, di), g.d_conv, dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "gate_a": dense_init(gen, (nb, w, w), w, dtype),
        "gate_i": dense_init(gen, (nb, w, w), w, dtype),
        "bias_a": torch.zeros(di, dtype=torch.float32, device=dev),
        "bias_i": torch.zeros(di, dtype=torch.float32, device=dev),
        "lam": lam,
        "w_out": dense_init(gen, (di, d), di, dtype),
    }


def rglru_specs(cfg: ArchConfig, tp: str = "model") -> dict:
    return {
        "w_x": P(None, tp),
        "w_y": P(None, tp),
        "conv_w": P(None, tp),
        "conv_b": P(tp),
        "gate_a": P(tp, None, None),
        "gate_i": P(tp, None, None),
        "bias_a": P(tp),
        "bias_i": P(tp),
        "lam": P(tp),
        "w_out": P(tp, None),
    }


def _gates(p, xb, nb: int, w: int):
    """Block-diagonal gate projections. xb: (B,S,di) f32."""
    b, s, di = xb.shape
    xr = xb.reshape(b, s, nb, w)
    ra = torch.einsum("bsnw,nwv->bsnv", xr, p["gate_a"].float())
    ri = torch.einsum("bsnw,nwv->bsnv", xr, p["gate_i"].float())
    r = torch.sigmoid(ra.reshape(b, s, di) + p["bias_a"])
    i = torch.sigmoid(ri.reshape(b, s, di) + p["bias_i"])
    return r, i


def _linear_scan(a, b):
    """Inclusive prefix scan of h_t = a_t h_{t-1} + b_t over axis 1 from
    h = 0, in ⌈log2 S⌉ steps. Returns (a_sc, b_sc): the products of the
    a's and the state from zero, so the state from h0 is b_sc + a_sc·h0."""
    s = a.shape[1]
    for step in (2 ** j for j in range(math.ceil(math.log2(max(s, 1))))):
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
    return a, b


def rglru_apply(cfg: ArchConfig, p: dict, x,
                cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (out, cache). cache: {'conv': (B,K-1,di), 'h': (B,di) f32},
    read as the state before ``x`` and written in place."""
    g = cfg.rglru
    b, s, d = x.shape
    di = g.d_inner(d)
    nb, w = di // g.block_width, g.block_width

    xb = x @ p["w_x"]
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                None if cache is None else cache["conv"])

    xf = xb.float()
    r, i = _gates(p, xf, nb, w)
    log_a = -_C * softplus(p["lam"]) * r                 # (B,S,di) ≤ 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0))
    bterm = beta * (i * xf)

    h0 = cache["h"] if cache is not None else None
    if cache is not None and s == 1:
        y = (a[:, 0] * h0 + bterm[:, 0])[:, None]
    else:
        a_sc, y = _linear_scan(a, bterm)
        if h0 is not None:
            y = y + a_sc * h0[:, None, :]                # fold in the state
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(y[:, -1])

    yg = F.gelu((x @ p["w_y"]).float(), approximate="tanh")
    out = (y * yg).to(x.dtype)
    return out @ p["w_out"], cache


def init_rglru_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                     device) -> dict:
    """RG-LRU state of ``n_layers`` layers, stacked on a leading layer axis:
    conv (n_layers, batch, K-1, di) in ``dtype``, h (n_layers, batch, di)
    f32."""
    g = cfg.rglru
    di = g.d_inner(cfg.d_model)
    return {
        "conv": torch.zeros((n_layers, batch, g.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((n_layers, batch, di), dtype=torch.float32,
                         device=device),
    }
