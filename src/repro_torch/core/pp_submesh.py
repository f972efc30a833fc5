"""Pipeline parallelism on a staged mesh of processes (port of
`repro/core/pp_submesh.py`): the rank pipeline step.

The reference lowers its staged step onto a ``("stage", "data", "model")``
jax mesh: stage ``s``'s layer weights live only on the stage-``s`` device
slice, the boundary activation goes to stage ``s+1`` by `jax.lax.ppermute`
over ``stage``, and the schedule runs tick by tick — ``microbatches + pp -
1`` ticks a step, stage ``s`` computing microbatch ``t - s`` at tick ``t``;
autodiff through the ppermute runs the reverse pipeline for the backward.

Here each process is one (stage, replica, rank) of a
`launch.mesh.make_staged_mesh` mesh and holds only its own stage's layers,
packed under that stage's `FailurePlan` (`ntp_train.pack_rank_params` with
``stage``): ``embed`` lives on stage 0, ``head`` and ``final_norm`` on the
last stage (the reference replicates them, but only stage 0 reads ``embed``
and only the last stage reads ``head``, so the numbers are the same). With
no stacked tree there is nothing to pad, so the reference's
`stack_staged_params` (pad slots to the widest stage's buffer, pad layers to
the deepest stage) has no counterpart; nor has its MoE slot table padded
to the widest stage with -1: a process takes its own (replica, rank) row
of its stage's ``comp_slots`` (`ntp_train.rank_moe_slots`), which is that
table's row without the padding. The MoE ``router`` is a stage-local
replicated leaf, as ``ln1``/``ln2``.

The step runs the reference's ticks: stage 0 embeds microbatch ``t``, every
other stage receives its input from the previous stage (`collectives.
StageLink.recv_prev`), runs its layers with the Megatron pair inside each
block, and hands the output on (`send_next`) or, on the last stage, takes
the token-loss total of the microbatch. The backward is per-rank autograd
over the same ticks in reverse: the last stage seeds each microbatch with
the loss over the global count, every stage sends its input's cotangent
back (`send_prev`) and the previous stage receives it as its output's
(`recv_next`) — the transpose of the hand-off, as AD through ``ppermute``
gives the reference. Loss and count are summed over (stage, data): every
process reports the same loss. Gradients then sync stage-locally over the
stage's ``data`` group (`core.overlap.make_sync_grads` on the mesh; with
``overlap`` the bucketed sync, one fused collective per (stage,
plan-kind)).

Hand-off bytes: a process sends an activation only for a real microbatch,
``microbatches`` sends a boundary. The reference's `ppermute` also sends on
every edge tick (``ticks - 1`` sends a boundary: `handoff_accounting`); at
pp=2 the two agree, at pp>=3 the reference's table counts ``pp - 2`` more
sends a boundary than this step makes (pinned in
tests/test_torch_pp_ranks.py).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import tree as tr
from repro_torch.configs.shapes import stage_boundaries
from repro_torch.core import collectives as C
from repro_torch.core import nonuniform as nu
from repro_torch.core import ntp_train as nt
from repro_torch.optim.base import Optimizer, sgd

STAGE_AXES = ("stage", "data", "model")


def is_staged_mesh(mesh) -> bool:
    """True for a mesh carrying a ``stage`` axis with >= 2 stages (the
    pipeline of processes); a 2-D mesh — or a degenerate stage axis of size
    1 — takes the stage-sequential route."""
    if mesh is None:
        return False
    names = getattr(mesh, "axis_names", ())
    return "stage" in names and mesh.shape["stage"] > 1


def validate_staged_mesh(mesh, pp: int) -> None:
    names = tuple(getattr(mesh, "axis_names", ()))
    if tuple(sorted(names)) != tuple(sorted(STAGE_AXES)):
        raise ValueError(
            f"submesh PP needs mesh axes {STAGE_AXES}, got {names} "
            "(build one with launch.mesh.make_staged_mesh)"
        )
    if mesh.shape["stage"] != pp:
        raise ValueError(
            f"mesh stage axis has {mesh.shape['stage']} stages but the plan "
            f"has pp={pp}; one submesh per pipeline stage is the contract"
        )


def _stage_geometry(cfg: nt.NTPModelConfig, staged: nu.StagedPlan):
    """Per-stage layer ids, per-stage weight plans, the deepest stage's
    layer count and per-kind widest buffer (max over stages) — the
    reference's stacking geometry, kept for the tests that hold the two
    packages to each other."""
    bounds = stage_boundaries(cfg.n_layers, staged.pp)
    stage_layers = [tuple(range(bounds[s], bounds[s + 1]))
                    for s in range(staged.pp)]
    l_max = max(len(ls) for ls in stage_layers)
    plans = [nt._plans(cfg, p) for p in staged.stages]
    u_max = {
        kind: max(sp[kind].comp_slots.shape[2] for sp in plans)
        for kind in ("attn", "mlp")
    }
    return stage_layers, l_max, plans, u_max


def handoff_accounting(cfg: nt.NTPModelConfig, staged: nu.StagedPlan, *,
                       local_batch: int, microbatches: int, seq_len: int):
    """Static ledger of one step's cross-stage activation traffic, as the
    reference's ppermute hand-off moves it: one f32 (mb, S, d_model)
    activation per sender rank per non-final tick, the same volume of
    cotangents back."""
    pp, d = staged.pp, staged.d
    mb = local_batch // microbatches
    ticks = microbatches + pp - 1
    act_bytes = 4 * mb * seq_len * cfg.d_model        # f32 (mb, S, d_model)
    senders = (pp - 1) * d * staged.n1                # rank columns that send
    sends = ticks - 1                                 # no send on final tick
    fwd = act_bytes * senders * sends
    return {
        "act_bytes_per_send": act_bytes,
        "sender_ranks": senders,
        "ticks": ticks,
        "sends_per_boundary": sends,
        "fwd_bytes": fwd,
        "bwd_bytes": fwd,                              # ppermute transpose
        "total_bytes": 2 * fwd,
    }


def make_submesh_train_step(
    cfg: nt.NTPModelConfig,
    staged: nu.StagedPlan,
    mesh,
    *,
    mode: Union[nt.Mode, str] = nt.Mode.NTP,
    local_batch: int = 4,
    optimizer: Optional[Optimizer] = None,
    local_batches=None,
    microbatches: int = 1,
    overlap: bool = False,
):
    """The rank pipeline step of one process of a staged mesh, with the
    reference's contract ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` is this process's packed share
    (`ntp_train.pack_rank_params` with its stage), ``batch`` the GLOBAL
    (D*local_batch, S+1) token array. ``loss`` and ``grad_norm`` are the
    global ones, equal on every process. Local batches follow the slowest
    stage (`StagedPlan.effective`).

    The step carries the reference's probes: ``ticks``, ``submesh``
    (True), ``handoff`` (the byte table, bound on the first call) and
    ``handoff_for(seq_len)``, ``overlap``, ``collectives`` (the whole
    mesh's unit-sync launches, as the reference counts them), ``grads_fn``
    and ``sync_fn``; also ``replicated_collectives`` (this process's)."""
    validate_staged_mesh(mesh, staged.pp)
    if (staged.d, staged.n1) != tuple(mesh):
        raise ValueError(f"plan {staged} does not fit mesh {tuple(mesh)}")
    mode = nt.Mode.coerce(mode)
    optimizer = optimizer or sgd(1e-2)
    nt.validate_microbatches(microbatches, local_batch)
    pp, s = staged.pp, mesh.stage
    masks = nt._sample_masks(nt._validated_local_batches(
        local_batches, staged.effective, mode, local_batch, staged.d))
    m = microbatches
    ticks = m + pp - 1
    first, last = s == 0, s == pp - 1
    own, _ = nt.stage_share(cfg, pp, s)
    link = C.StageLink(mesh)

    def loss_and_grads(params, batch):
        """Global loss and this process's pre-sync gradients, through the
        pipeline's forward ticks and their reverse."""
        dev = mesh.device
        tokens, mask = nt._rank_tokens(batch, mesh, masks, dev)
        mb, seq = tokens.shape[0] // m, tokens.shape[1] - 1
        leaves = nt._grad_leaves(params)
        flat = tr.leaves(leaves)
        uids = nt.rank_moe_slots(cfg, staged, mesh, dev)
        like = torch.empty((mb, seq, cfg.d_model), device=dev)
        ins, outs = [None] * m, [None] * m
        total = count = None
        for t in range(ticks):
            j = t - s
            if not 0 <= j < m:
                continue
            rows = slice(j * mb, (j + 1) * mb)
            if first:
                x = leaves["embed"][tokens[rows, :-1]]
            else:
                x = ins[j] = link.recv_prev(like).requires_grad_(True)
            for li in own:
                x = nt._rank_layer(leaves["layers"][li], x, cfg, mesh.model,
                                   None if uids is None else uids[li])
            if last:
                tot, cnt = nt._rank_tail(leaves["final_norm"], leaves["head"],
                                         x, tokens[rows, 1:], mask[rows])
                outs[j] = tot
                total = tot.detach() if total is None else total + tot.detach()
                count = cnt if count is None else count + cnt
            else:
                link.send_next(x)
                outs[j] = x
        # loss and count summed over (stage, data): the last stage's
        # replicas first, then every stage of this (replica, rank)
        tc = C.psum(torch.stack([total, count]), mesh.data) if last else \
            torch.zeros(2, device=dev)
        tc = C.psum_(tc, mesh.pipe)
        denom = torch.clamp(tc[1], min=1.0)
        acc = [None] * len(flat)
        for t in reversed(range(ticks)):
            j = t - s
            if not 0 <= j < m:
                continue
            if last:
                root, seed = outs[j] / denom, None
            else:
                root, seed = outs[j], link.recv_next(like)
            want = flat + ([] if first else [ins[j]])
            grads = list(torch.autograd.grad(root, want, grad_outputs=seed))
            if not first:
                link.send_prev(grads.pop())
            for i, g in enumerate(grads):
                acc[i] = g if acc[i] is None else acc[i].add_(g)
            del grads, root, seed
            outs[j] = ins[j] = None
        return tc[0] / denom, nt._unflatten_like(leaves, acc)

    from repro_torch.core import overlap as ov

    sync_grads = ov.make_sync_grads(cfg, staged, mode=mode, bucketed=overlap,
                                    mesh=mesh)

    def step(params, opt_state, batch):
        if step.handoff is None:
            # seq len arrives with the first batch; bind the byte table then
            step.handoff = step.handoff_for(batch.shape[1] - 1)
        loss, grads = loss_and_grads(params, batch)
        grads = sync_grads(grads)
        params, opt_state, metrics = optimizer.update(
            grads, opt_state, params,
            grad_norm=nt.rank_grad_norm(grads, mesh))
        return params, opt_state, dict(metrics, loss=loss)

    step.ticks = ticks
    step.submesh = True
    step.handoff = None
    step.handoff_for = lambda seq_len: handoff_accounting(
        cfg, staged, local_batch=local_batch, microbatches=m,
        seq_len=seq_len)
    step.overlap = overlap
    step.collectives = sync_grads.collectives
    step.replicated_collectives = sync_grads.replicated_collectives
    step.grads_fn = loss_and_grads
    step.sync_fn = sync_grads
    return step
