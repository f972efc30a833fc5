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

``mesh=None`` is the one-device step. ``mesh`` = a `launch.mesh.RankMesh`
(one process per (replica, rank), global rank ``replica·n_model + rank``,
the reference's row-major ``("data", "model")`` order) gives this process's
sharded steps, for the attention archs (every block ``attn``, ``attn_sw``
or ``attn_chunked``, with a dense or an MoE FFN): the `Setup` carries the
sanitized ``param_specs``, ``opt_specs`` (ZeRO-1 ``m``/``v``/``master``,
``step`` replicated) and ``cache_specs``, and the steps take this
process's shards (`Setup.place`, `Setup.init_opt_state`) and the global
batch, of which each process takes its replica's rows. The train step:

* runs the model rank-local (`models.common.ShardCtx`: Megatron's
  column/row pairs, heads split mid-head where ``n_model`` does not
  divide H, a vocab-parallel embedding and head, the expert-parallel MoE
  FFN), so every gradient of a leaf split over ``model`` is its shard's,
  every replicated leaf outside a region whole on every rank, and the
  replicated leaves inside one (``wk``/``wv``/``bk``/``bv``,
  ``q_norm``/``k_norm``, the router) summed over ``model`` by
  `ShardCtx.enter`; the MoE aux loss's statistics are averaged over the
  mesh with the adjoint that survives the ``data`` mean below
  (`core.collectives.mesh_mean`);
* takes the loss vocab-parallel (`vocab_parallel_cross_entropy`);
* averages every gradient and the losses over ``data``;
* clips by the global norm (each model-split leaf's shards counted once,
  each replicated leaf once) and updates AdamW ZeRO-1: each process
  updates its ``data`` slice of its moments, params (and master), then
  all-gathers the params over ``data``.

Prefill and decode return the last position's logits of this replica's
rows, gathered over ``model``, and this process's cache shard. A part
not ported yet (an SSD or RG-LRU block, an encoder, a batch that does
not split over ``data`` in prefill or decode) raises
`NotImplementedError` naming its ROADMAP row; wrong input (a train
batch that does not split, microbatches with an MoE arch, experts that
do not split over ``model``) raises `ValueError`. No mesh falls back to
one device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.collectives import (
    all_gather_units, pmax_, psum_, reduce_from_model,
)
from repro_torch.data.pipeline import InputSpec, input_specs, shard_batch
from repro_torch.launch.mesh import RankMesh
from repro_torch.models.attention import local_heads
from repro_torch.models.common import P, ShardCtx
from repro_torch.models.transformer import Model, build_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from repro_torch.sharding.specs import (
    data_slice, param_shardings, place, splits_over, zero1_shardings,
)

ROADMAP_7G = "ROADMAP Queue 1, 7g"


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


def vocab_parallel_cross_entropy(logits, targets, real_vocab: int, mesh):
    """`cross_entropy` of logits split over the ``model`` group of
    ``mesh``: ``logits`` (B, S, vp / n_model) are this rank's vocabulary
    slice, global ids ``[rank·vp/n, (rank+1)·vp/n)``. The padded ids (global
    id >= ``real_vocab``) are masked, the max and the sum of exponentials
    reduced over ``model``, the target logit taken from the rank that owns
    it. Equal on every rank of the group; each rank's backward gives its
    slice's gradient."""
    logits = logits.float()
    vl = logits.shape[-1]
    lo = mesh.rank * vl
    if vl * mesh.n_model != real_vocab:
        pad = torch.arange(lo, lo + vl, device=logits.device) >= real_vocab
        logits = torch.where(pad, -1e30, logits)
    m = pmax_(logits.amax(-1, keepdim=True).detach().contiguous(), mesh.model)
    sums = reduce_from_model(torch.sum(torch.exp(logits - m), dim=-1),
                             mesh.model)
    lse = m[..., 0] + torch.log(sums)
    t = targets.long() - lo
    own = (t >= 0) & (t < vl)
    ll = torch.gather(logits, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(own, ll, torch.zeros_like(ll)),
                           mesh.model)
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
    # (on a mesh: of the global batch, averaged over ``data``)
    grad_fn: Callable = None
    # on a mesh: the sanitized spec trees (None on one device)
    param_specs: Any = None
    opt_specs: Any = None
    cache_specs: Any = None
    # the reference's sequence-parallel gate (recorded, not acted on)
    sp: bool = False

    def place(self, params):
        """This process's shards of full ``params`` (tensors or numpy; a
        copy of each leaf on one device)."""
        if self.mesh is None:
            return tr.tree_map(
                lambda a: torch.as_tensor(a).to(self.model.device, copy=True),
                params)
        return place(params, self.param_specs, self.mesh)

    def init_params(self, generator: torch.Generator):
        """The model's parameters drawn from ``generator`` (`Model.init`);
        on a mesh, this process's shards of them, each leaf cut as it is
        drawn (`Model.init_shards`: the same values as `place` of the
        whole draw, without holding the whole model)."""
        if self.mesh is None:
            return self.model.init(generator)
        return self.model.init_shards(generator, self.param_specs, self.mesh)

    def init_opt_state(self, params):
        """`adamw_init` of (this process's) ``params``; on a mesh each
        moment (and the f32 master) is this process's ZeRO-1 slice."""
        if self.mesh is None:
            return adamw_init(params, self.opt_cfg)
        sp, mesh = self.opt_specs, self.mesh
        state = {
            k: tr.tree_map(lambda p, s: torch.zeros(
                data_slice(p, s, mesh).shape, dtype=torch.float32,
                device=p.device), params, sp[k])
            for k in ("m", "v")}
        state["step"] = torch.zeros((), dtype=torch.int32,
                                    device=self.model.device)
        if "master" in sp:
            state["master"] = tr.tree_map(
                lambda p, s: data_slice(p, s, mesh)
                .to(torch.float32, copy=True).contiguous(),
                params, sp["master"])
        return state


def check_sharded_arch(cfg: ArchConfig) -> None:
    """Raise `NotImplementedError`, naming its ROADMAP row, for a config
    outside sharded execution: an SSD or RG-LRU block, an encoder."""
    kinds = set(cfg.layer_pattern)
    if kinds & {"ssm", "rglru"}:
        raise NotImplementedError(
            f"{cfg.arch_id}: {sorted(kinds & {'ssm', 'rglru'})} blocks on a "
            f"mesh are not ported ({ROADMAP_7G}: Mamba-2 and RG-LRU on the "
            "mesh)")
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: an encoder on a mesh is not ported "
            f"({ROADMAP_7G}: whisper's encoder and cross bank)")


def _check_mesh(cfg: ArchConfig, shape: ShapeSpec, mesh) -> None:
    """Refuse what sharded execution does not cover, naming its ROADMAP
    row."""
    if not isinstance(mesh, RankMesh):
        raise NotImplementedError(
            f"make_setup: a mesh is a launch.mesh.RankMesh (one process per "
            f"(replica, rank); {ROADMAP_7G}: 'sharded arch-stack "
            f"execution'), got {type(mesh).__name__}")
    if mesh.pp > 1:
        raise NotImplementedError(
            f"make_setup: a staged mesh (pp={mesh.pp}) is the NTP "
            f"prototype's; the arch stack runs on a (data, model) mesh "
            f"({ROADMAP_7G}: 'sharded arch-stack execution')")
    check_sharded_arch(cfg)
    if shape.global_batch % mesh.n_data:
        if shape.kind == "train":
            raise ValueError(
                f"global_batch={shape.global_batch} does not split over "
                f"data={mesh.n_data}")
        raise NotImplementedError(
            f"{cfg.arch_id}: a {shape.kind} batch of {shape.global_batch} "
            f"over data={mesh.n_data} takes the reference's "
            "context-parallel K/V layout P(None, None, ('data', 'model'), "
            f"...), not ported ({ROADMAP_7G}: the context-parallel K/V "
            "layout)")
    if (cfg.n_heads * cfg.head_dim) % mesh.n_model == 0:
        local_heads(cfg, mesh.n_model, mesh.rank)
    if cfg.moe is not None and cfg.moe.n_experts % mesh.n_model:
        raise ValueError(
            f"{cfg.arch_id}: {cfg.moe.n_experts} experts do not split over "
            f"model={mesh.n_model} (expert parallelism gives each model "
            "rank E/n_model experts, as the reference's shard_map)")


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
    sp = (shape.kind == "train" and "rglru" not in cfg.layer_pattern
          and not cfg.post_norms)
    if mesh is not None:
        _check_mesh(cfg, shape, mesh)
        if device is not None and torch.device(device).type != \
                mesh.device.type:
            raise ValueError(f"device={device!r}, the mesh computes on "
                             f"{mesh.device}")
        if tuple(dp_axes) != ("data",):
            raise ValueError(f"dp_axes={dp_axes}: a (data, model) mesh of "
                             "processes has one data axis, 'data'")
    model = build_model(cfg, param_dtype=param_dtype, remat=remat,
                        device=device,
                        ctx=None if mesh is None else ShardCtx(mesh))
    opt_cfg = opt_cfg or AdamWConfig()
    su = Setup(cfg=cfg, shape=shape, mesh=mesh, model=model, opt_cfg=opt_cfg,
               batch_specs=input_specs(cfg, shape), sp=sp)
    if mesh is not None:
        _sharded_setup(su, dp_axes, lr_schedule, microbatches)
        return su

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


# ---------------------------------------------------------------------------
# sharded steps (one process of a RankMesh)

def _sharded_setup(su: Setup, dp_axes, lr_schedule, microbatches: int):
    cfg, shape, mesh, model, opt_cfg = (su.cfg, su.shape, su.mesh, su.model,
                                        su.opt_cfg)
    ms = mesh.shape
    su.batch_specs = input_specs(cfg, shape, ms, dp_axes)
    pshape = model.param_shapes()
    su.param_specs = param_shardings(ms, model.param_specs(), pshape)
    b_local = shape.global_batch // mesh.n_data
    if shape.kind == "train":
        ospec = {"m": zero1_shardings(ms, model.param_specs(), pshape,
                                      dp_axes)}
        ospec["v"] = ospec["m"]
        if opt_cfg.keep_master and model.param_dtype != torch.float32:
            ospec["master"] = ospec["m"]
        ospec["step"] = P()
        su.opt_specs = ospec
    else:
        cshape = model.init_cache(shape.global_batch, shape.seq_len,
                                  torch.bfloat16, device="meta")
        su.cache_specs = model.cache_specs(cshape, ms, dp_axes)

    if shape.kind == "prefill":

        @torch.no_grad()
        def prefill_step(params, batch):
            local = shard_batch(batch, su.batch_specs, mesh)
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     torch.bfloat16, specs=su.cache_specs)
            logits, cache = model.prefill(params, local["tokens"].long(),
                                          cache, specs=su.cache_specs)
            return logits[:, -1], cache

        su.step_fn = prefill_step
        return
    if shape.kind == "decode":

        @torch.no_grad()
        def serve_step(params, cache, batch):
            local = shard_batch(batch, su.batch_specs, mesh)
            logits, cache = model.decode_step(params, cache,
                                              local["tokens"].long(),
                                              int(batch["pos"]),
                                              specs=su.cache_specs)
            return logits[:, 0], cache

        su.step_fn = serve_step
        return

    if b_local % microbatches:
        raise ValueError(
            f"microbatches={microbatches} does not divide the local batch "
            f"{b_local} (global {shape.global_batch} over data="
            f"{mesh.n_data})")
    vocab_split = splits_over(su.param_specs["embed"], "model")
    split = [splits_over(s, "model") for s in tr.leaves(su.param_specs)]
    data_dims = [next((d for d, e in enumerate(tuple(s)) if e == "data"),
                      None) for s in tr.leaves(su.opt_specs["m"])]

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch["tokens"])
        if vocab_split:
            loss = vocab_parallel_cross_entropy(logits, batch["targets"],
                                                cfg.vocab_size, mesh)
        else:
            loss = cross_entropy(logits, batch["targets"], cfg.vocab_size)
        return loss + aux["moe_aux_loss"], loss

    def local_value_and_grad(params, batch):
        live = tr.tree_map(lambda p: p.detach().requires_grad_(), params)
        m, mb = microbatches, b_local // microbatches
        total = ce = torch.zeros((), dtype=torch.float32, device=model.device)
        with torch.enable_grad():
            for j in range(m):
                sl = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
                t, c = loss_fn(live, sl)
                (t / m if m > 1 else t).backward()
                total, ce = total + t.detach(), ce + c.detach()
        return (total / m, ce / m), tr.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            live)

    def value_and_grad(params, batch):
        """The global batch's ((total, ce), grads), each process's grads
        those of its shards, averaged over ``data``."""
        local = shard_batch(batch, su.batch_specs, mesh)
        (total, ce), grads = local_value_and_grad(params, local)
        if mesh.n_data == 1:        # one replica: nothing to average
            return (total, ce), grads
        for g in tr.leaves(grads):
            psum_(g, mesh.data).div_(mesh.n_data)
        tc = psum_(torch.stack([total, ce]), mesh.data).div_(mesh.n_data)
        return (tc[0], tc[1]), grads

    def grad_norm(grads):
        """The one-device global norm: model-split leaves summed over
        ``model``, replicated leaves counted once."""
        sq = [torch.sum(torch.square(g.float())) for g in tr.leaves(grads)]
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        sharded = sum((q for q, s in zip(sq, split) if s), zero)
        replicated = sum((q for q, s in zip(sq, split) if not s), zero)
        return torch.sqrt(psum_(sharded.contiguous(), mesh.model)
                          + replicated)

    def train_step(params, opt_state, batch):
        (total, ce), grads = value_and_grad(params, batch)
        gnorm = grad_norm(grads)
        # the ZeRO-1 slices (views): AdamW updates the params' in place
        p_cut, g_cut = (tr.tree_map(lambda x, s: data_slice(x, s, mesh),
                                    tree, su.opt_specs["m"])
                        for tree in (params, grads))
        _, opt_state, metrics = adamw_update(
            g_cut, opt_state, p_cut, opt_cfg,
            lr_schedule(opt_state["step"]), grad_norm=gnorm)
        with torch.no_grad():
            for p, sl, d in zip(tr.leaves(params), tr.leaves(p_cut),
                                data_dims):
                if d is not None:
                    parts = all_gather_units(sl, mesh.data)
                    p.copy_(parts.movedim(0, d).reshape(p.shape))
        metrics.update(loss=ce, total_loss=total)
        if microbatches > 1:
            metrics["microbatches"] = torch.tensor(microbatches,
                                                   dtype=torch.int32)
        return params, opt_state, metrics

    su.step_fn = train_step
    su.grad_fn = value_and_grad
