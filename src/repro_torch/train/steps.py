"""Step functions of the uniform arch stack (train / prefill / decode) —
port of `repro/train/steps.py`.

``make_setup`` assembles, for one (arch × input shape): the model
(`models.transformer.Model`), the input specs (`data.pipeline.input_specs`)
and the step function, so the launcher, the session and the tests share one
code path. Every step is a plain function of tensors (no compilation); the
train step consumes its params and optimizer state (AdamW updates them in
place, as the reference donates them) and returns them.

The train step differentiates `Model.forward`, the plain route that
computes what the reference's training forward computes (it runs no
kernel: the hand kernels are forward-only). ``prefill`` and ``decode`` wrap
the served model's `prefill` / `decode_step`, so on the card they launch
`flash_attention`, `rmsnorm` and, for Mamba-2, `ssd_scan`; they run under
``torch.no_grad``.

``mesh=None`` is the one-device step, the only one ported: a mesh raises
`NotImplementedError` naming the ROADMAP row of sharded execution (the
layouts it will place are `Model.param_specs` through `sharding.specs`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import InputSpec, input_specs
from repro_torch.models.transformer import Model, build_model
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine


# ---------------------------------------------------------------------------
# loss

def cross_entropy(logits, targets, real_vocab: int):
    """Mean next-token CE over (B,S). Handles Megatron vocab padding by
    masking padded logits; fp32 reductions."""
    logits = logits.float()
    vp = logits.shape[-1]
    if vp != real_vocab:
        pad = torch.arange(vp, device=logits.device) >= real_vocab
        logits = torch.where(pad, -1e30, logits)
    m = logits.amax(-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


# ---------------------------------------------------------------------------
# setup bundle

@dataclass
class Setup:
    cfg: ArchConfig
    shape: ShapeSpec
    mesh: Any
    model: Model
    opt_cfg: Optional[AdamWConfig]
    batch_specs: Dict[str, InputSpec] = field(default_factory=dict)
    step_fn: Callable = None
    # train: the step's value-and-grad, ``((total, ce), grads)`` at params
    grad_fn: Callable = None


def make_setup(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh=None,
    *,
    dp_axes=("data",),
    param_dtype=torch.bfloat16,
    opt_cfg: Optional[AdamWConfig] = None,
    remat: bool = True,
    microbatches: int = 1,
    lr_schedule: Callable = functools.partial(warmup_cosine, warmup=100,
                                              total=10_000),
    device=None,
) -> Setup:
    """``microbatches`` > 1 splits each train step's batch into that many
    equal chunks and accumulates their gradients (one optimizer update per
    step; the mean of the chunks' mean gradients is the full batch's).
    ``microbatches=1`` is the plain step. The model lives on ``device``
    (CUDA unless ``device="cpu"``)."""
    if shape.kind == "train":
        if not 1 <= microbatches <= shape.global_batch:
            raise ValueError(
                f"microbatches={microbatches} outside "
                f"[1, global_batch={shape.global_batch}]"
            )
        if shape.global_batch % microbatches:
            raise ValueError(
                f"global_batch={shape.global_batch} not divisible by "
                f"microbatches={microbatches}"
            )
        if microbatches > 1 and cfg.moe is not None:
            # the load-balance aux loss is nonlinear in per-batch routing
            # statistics: the mean of the chunks' aux is not the full
            # batch's, so accumulated grads would differ from m=1
            raise ValueError(
                f"microbatches={microbatches} with a MoE arch "
                f"({cfg.arch_id}): the load-balance aux loss is not "
                "additive over microbatch chunks, so accumulated grads "
                "would differ from the full-batch step"
            )
    elif microbatches != 1:
        raise ValueError(f"microbatches only applies to train shapes, "
                         f"got kind={shape.kind!r}")
    if mesh is not None:
        raise NotImplementedError(
            "make_setup: a mesh is not ported to repro_torch yet; mesh=None "
            "is the one-device step (ROADMAP Queue 1: 'sharded arch-stack "
            "execution')")
    model = build_model(cfg, param_dtype=param_dtype, remat=remat,
                        device=device)
    opt_cfg = opt_cfg or AdamWConfig()
    su = Setup(cfg=cfg, shape=shape, mesh=mesh, model=model, opt_cfg=opt_cfg,
               batch_specs=input_specs(cfg, shape))

    if shape.kind == "train":

        def loss_fn(params, batch):
            logits, aux = model.forward(
                params, batch["tokens"], enc_input=batch.get("enc_input"))
            loss = cross_entropy(logits, batch["targets"], cfg.vocab_size)
            return loss + aux["moe_aux_loss"], loss

        def value_and_grad(params, batch):
            """((total, ce), grads) of ``loss_fn`` at ``params``: the
            leaves are differentiated as detached views (no copy)."""
            live = tr.tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                total, ce = loss_fn(live, batch)
                total.backward()
            return ((total.detach(), ce.detach()), tr.tree_map(
                lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                live))

        def update(params, opt_state, grads):
            lr_scale = lr_schedule(opt_state["step"])
            return adamw_update(grads, opt_state, params, opt_cfg, lr_scale)

        def train_step(params, opt_state, batch):
            (total, ce), grads = value_and_grad(params, batch)
            params, opt_state, metrics = update(params, opt_state, grads)
            metrics.update(loss=ce, total_loss=total)
            return params, opt_state, metrics

        def microbatched_train_step(params, opt_state, batch):
            m = microbatches
            mb = shape.global_batch // m
            grads = None
            total = ce = torch.zeros((), dtype=torch.float32,
                                     device=model.device)
            for j in range(m):
                sl = {k: (v[j * mb:(j + 1) * mb]
                          if getattr(v, "ndim", 0) >= 1
                          and v.shape[0] == shape.global_batch else v)
                      for k, v in batch.items()}
                (t, c), g = value_and_grad(params, sl)
                total, ce = total + t, ce + c
                grads = g if grads is None else tr.tree_map(
                    lambda a, b: a.add_(b), grads, g)
            grads = tr.tree_map(lambda x: x.div_(m), grads)
            params, opt_state, metrics = update(params, opt_state, grads)
            metrics.update(loss=ce / m, total_loss=total / m,
                           microbatches=torch.tensor(m, dtype=torch.int32))
            return params, opt_state, metrics

        su.step_fn = (train_step if microbatches == 1
                      else microbatched_train_step)
        su.grad_fn = value_and_grad

    elif shape.kind == "prefill":

        @torch.no_grad()
        def prefill_step(params, batch):
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     torch.bfloat16)
            logits, cache = model.prefill(params, batch["tokens"].long(),
                                          cache,
                                          enc_input=batch.get("enc_input"))
            return logits[:, -1], cache

        su.step_fn = prefill_step

    else:  # decode

        @torch.no_grad()
        def serve_step(params, cache, batch):
            """One token against ``cache`` at write index ``batch["pos"]``.
            An enc-dec config's cross-attention reads the encoder K/V its
            prefill banked in the cache (the reference recomputes them from
            ``batch["enc_out"]``, the same encoder output)."""
            logits, cache = model.decode_step(params, cache,
                                              batch["tokens"].long(),
                                              int(batch["pos"]))
            return logits[:, 0], cache

        su.step_fn = serve_step

    return su
