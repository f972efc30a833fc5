"""Pluggable optimizer interface for the step builders (port of
`repro/optim/base.py`)::

    state = opt.init(params)
    params, state, metrics = opt.update(grads, state, params,
                                        norm_weights=None)

``metrics`` always contains ``grad_norm`` and ``lr``; every state dict
carries an int32 ``step`` counter. ``norm_weights`` corrects the global
grad norm when the gradient tree holds redundant copies (1/D for packed
unit buffers). States whose extra leaves mirror the param tree (AdamW's
``m``/``v``/``master``) advertise them in ``param_like`` so the session can
repack them across failure plans. `update` consumes ``params`` and
``state`` as the reference's donating step does: it updates them in place
and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state, metrics)
    param_like: Tuple[str, ...] = ()  # state keys structured like the params


def sgd(lr: float) -> Optimizer:
    """Plain SGD — used where exact equivalence to a hand-derived reference
    matters (no clipping, no adaptive state)."""

    def init(params):
        dev = tr.leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, norm_weights=None):
        gnorm = global_norm(grads, norm_weights)
        for p, g in zip(tr.leaves(params), tr.leaves(grads)):
            p.sub_(lr * g)
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32)}
        return params, {"step": state["step"] + 1}, metrics

    return Optimizer(name="sgd", init=init, update=update)


def adamw(cfg: Optional[AdamWConfig] = None,
          lr_schedule: Optional[Callable] = None) -> Optimizer:
    """AdamW with an optional lr schedule on the state's step counter."""
    cfg = cfg or AdamWConfig()

    def init(params):
        return adamw_init(params, cfg)

    def update(grads, state, params, norm_weights=None):
        scale = lr_schedule(state["step"]) if lr_schedule is not None else 1.0
        return adamw_update(grads, state, params, cfg, scale,
                            norm_weights=norm_weights)

    return Optimizer(
        name="adamw", init=init, update=update,
        param_like=("m", "v", "master"),
    )
