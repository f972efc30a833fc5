"""AdamW with fp32 moments (+ an fp32 master copy when params are
low-precision) — port of `repro/optim/adamw.py`.

Like the reference's step, which donates its params and optimizer state,
`adamw_update` consumes them: it updates params and moments IN PLACE and
returns them, so a step holds one copy of the weights, not two. The
arithmetic is the reference's op for op (f32 bias corrections from the
int32 step; a pad slot with zero grad, moments and weight stays exactly
zero: its update is 0/(0+eps) = 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as tr


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    keep_master: bool = True  # fp32 master copy when params are low-precision


def adamw_init(params, cfg: AdamWConfig) -> dict:
    leaves = tr.leaves(params)
    state = {
        "m": tr.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params),
        "v": tr.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }
    if cfg.keep_master and any(p.dtype != torch.float32 for p in leaves):
        state["master"] = tr.tree_map(lambda p: p.to(torch.float32), params)
    return state


def global_norm(tree, norm_weights=None) -> torch.Tensor:
    """L2 norm of a gradient tree. ``norm_weights`` (matching tree of
    scalars) weights each leaf's squared contribution — the NTP step uses
    1/D for packed unit buffers, which hold D identical replica copies of
    every synced unit gradient, so the result equals the canonical norm."""
    gs = tr.leaves(tree)
    if norm_weights is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    return torch.sqrt(sum(
        w * torch.sum(torch.square(g.float()))
        for g, w in zip(gs, tr.leaves(norm_weights))
    ))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0,
                 norm_weights=None, grad_norm=None):
    """Returns (params, state, metrics); params and moments are updated in
    place (see the module docstring). ``grad_norm``, when given, is the
    global norm to clip by (the process path sums it over ranks)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, norm_weights) if grad_norm is None \
        else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    f32 = dict(dtype=torch.float32, device=step.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), step.to(torch.float32))
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), step.to(torch.float32))
    lr = cfg.lr * lr_scale

    master = state.get("master", params)
    for g, m, v, p32, p in zip(tr.leaves(grads), tr.leaves(state["m"]),
                               tr.leaves(state["v"]), tr.leaves(master),
                               tr.leaves(params)):
        g = g.to(torch.float32) * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32.sub_(lr * (update + cfg.weight_decay * p32))
        if p32 is not p:
            p.copy_(p32)

    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if "master" in state:
        new_state["master"] = state["master"]
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32)}
    return params, new_state, metrics
