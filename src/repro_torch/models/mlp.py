"""Dense MLP (SwiGLU/GeGLU/plain) — port of the dense half of
`repro/models/mlp.py` (the MoE FFN waits for its slice). The three
products stay `torch.matmul`, as the reference leaves them to XLA."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import act_fn, dense_init


def mlp_init(cfg: ArchConfig, gen: torch.Generator, dtype,
             d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, (d, ff), d, dtype),
        "w_down": dense_init(gen, (ff, d), ff, dtype),
    }
    if cfg.ffn_gated:
        p["w_gate"] = dense_init(gen, (d, ff), d, dtype)
    return p


def mlp_apply(cfg: ArchConfig, p: dict, x):
    act = act_fn(cfg.ffn_act)
    h = x @ p["w_up"]
    if cfg.ffn_gated:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]
