"""Dense MLP (SwiGLU/GeGLU/plain) and Mixture-of-Experts FFN — port of
`repro/models/mlp.py`. The products stay `torch.matmul`/`einsum`, as the
reference leaves them to XLA (no Pallas kernel runs in either FFN).

MoE: a softmax router picks ``top_k`` experts a token (gates renormalised);
dispatch and combine are the reference's sort-based, capacity-bounded
scatter: slots sorted by expert (a stable sort, as ``jnp.argsort``), the
first ``cap`` slots of each expert kept and the rest dropped (the Switch
rule). The reference's out-of-range scatter index ``E·cap`` with
``mode="drop"`` becomes one spare row, sliced off; its clamped gather of
that index becomes a clamped index whose rows the ``keep`` mask zeroes.
`moe_apply_expert_parallel` is the reference's expert-parallel form, the
MoE FFN of a model on a mesh of processes (`models.common.ShardCtx` on a
`launch.mesh.RankMesh`), trained, prefilled and decoded: each process
holds ``E/n_model`` experts and dispatches its share of its replica's
tokens; one all-to-all over the model group carries each expert's slots
to the process that owns the expert and one brings them back, both with
a backward (`core.collectives.all_to_all`). `moe_apply_dense_ref` (every
expert on every token) is the oracle.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.models.common import NO_SHARD, P, ShardCtx, act_fn, dense_init


# ---------------------------------------------------------------------------
# dense MLP

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


def mlp_specs(cfg: ArchConfig, tp: str = "model") -> dict:
    s = {"w_up": P(None, tp), "w_down": P(tp, None)}
    if cfg.ffn_gated:
        s["w_gate"] = P(None, tp)
    return s


def mlp_apply(cfg: ArchConfig, p: dict, x, ctx: ShardCtx = NO_SHARD):
    """The dense FFN. On a mesh (``ctx``) whose ``model`` axis splits
    ``d_ff``, ``w_up``/``w_gate`` are this rank's columns and ``w_down``
    its rows (Megatron's column/row pair): the input enters the region and
    the partial output is reduced over ``model``."""
    split = ctx.mesh is not None and p["w_up"].shape[1] != cfg.d_ff
    if split:
        x = ctx.enter(x)
    act = act_fn(cfg.ffn_act)
    h = x @ p["w_up"]
    if cfg.ffn_gated:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    out = h @ p["w_down"]
    return ctx.exit(out) if split else out


# ---------------------------------------------------------------------------
# MoE

def moe_init(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    """Router (f32, as the reference), expert-stacked ``w_up``/``w_down``
    (and ``w_gate`` when gated) of shape (E, d, ff)/(E, ff, d), and the
    always-on ``shared`` / parallel ``dense`` MLPs the spec asks for."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.arch_id} has no MoE spec")
    m, d, ff = cfg.moe, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, (d, m.n_experts), d, torch.float32),
        "w_up": dense_init(gen, (m.n_experts, d, ff), d, dtype),
        "w_down": dense_init(gen, (m.n_experts, ff, d), ff, dtype),
    }
    if cfg.ffn_gated:
        p["w_gate"] = dense_init(gen, (m.n_experts, d, ff), d, dtype)
    if m.shared_expert:
        p["shared"] = mlp_init(cfg, gen, dtype)
    if m.dense_residual:
        p["dense"] = mlp_init(cfg, gen, dtype)
    return p


def moe_specs(cfg: ArchConfig, tp: str = "model") -> dict:
    if cfg.moe is None:
        raise ValueError(f"{cfg.arch_id} has no MoE spec")
    s = {
        "router": P(None, None),
        "w_up": P(tp, None, None),   # expert-parallel over the scale-up domain
        "w_down": P(tp, None, None),
    }
    if cfg.ffn_gated:
        s["w_gate"] = P(tp, None, None)
    if cfg.moe.shared_expert:
        s["shared"] = mlp_specs(cfg, tp)
    if cfg.moe.dense_residual:
        s["dense"] = mlp_specs(cfg, tp)
    return s


def _route(m: MoESpec, logits):
    """(N, E) router logits -> (N, k) expert ids, f32 combine weights
    (renormalised over the k picks) and the (N, E) f32 probabilities.
    Equal probabilities (underflowed to 0, say) go to the lower expert id
    first, as ``lax.top_k`` orders them: a stable descending sort, where
    ``torch.topk`` leaves ties in no stated order."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :m.top_k], idx[..., :m.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return idx, w, probs


def _experts(cfg: ArchConfig, p: dict, buf):
    """Each expert's FFN on its slots: buf (E', C, d) -> (E', C, d)."""
    act = act_fn(cfg.ffn_act)
    h = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    if cfg.ffn_gated:
        h = act(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) * h
    else:
        h = act(h)
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def _capacity(m: MoESpec, n: int) -> int:
    """Slots an expert takes from ``n`` tokens: ``round(n·k/E·cf)``, at
    least 1."""
    return int(max(1, round(n * m.top_k / m.n_experts * m.capacity_factor)))


def _dispatch(m: MoESpec, idx, cap: int):
    """The sort-based dispatch table of (N, k) expert picks: the slot order
    (stable sort by expert), each slot's source token, whether it is kept
    (its rank among its expert's slots < ``cap``) and its buffer row
    (``E·cap`` — one past the end — for a dropped slot)."""
    n, k = idx.shape
    e = m.n_experts
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=idx.device))
    pos_in_e = torch.arange(n * k, device=idx.device) - start[sorted_e]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(sorted_e, e * cap))
    return flat_e, order, order // k, keep, dest


def _scatter(xf, tok, dest, rows: int):
    """Buffer of ``rows`` slots holding token ``tok[i]`` at row
    ``dest[i]``; a dest of ``rows`` (a dropped slot) lands in a spare row
    that is cut off."""
    buf = xf.new_zeros((rows + 1, xf.shape[1]))
    return buf.index_put((dest,), xf[tok])[:rows]


def _combine(y, keep, dest, slot_w, tok, n: int):
    """Gather each kept slot's expert output from ``y`` (rows, d), weight
    it and sum it into its token: (n, d)."""
    rows = y.shape[0]
    gathered = torch.where(keep[:, None], y[dest.clamp(max=rows - 1)],
                           torch.zeros((), dtype=y.dtype, device=y.device))
    contrib = gathered * slot_w[:, None].to(y.dtype)
    return y.new_zeros((n, y.shape[1])).index_add(0, tok, contrib)


def _load(flat_e, e: int, n_slots: int):
    """Fraction of the slots routed to each expert, f32 (E,)."""
    ones = torch.ones(flat_e.shape, dtype=torch.float32,
                      device=flat_e.device)
    return torch.zeros(e, dtype=torch.float32,
                       device=flat_e.device).index_add(0, flat_e, ones) \
        / n_slots


def _side_mlps(cfg: ArchConfig, p: dict, x, out, ctx: ShardCtx = NO_SHARD):
    if cfg.moe.shared_expert:
        out = out + mlp_apply(cfg, p["shared"], x, ctx)
    if cfg.moe.dense_residual:
        out = out + mlp_apply(cfg, p["dense"], x, ctx)
    return out


# the dropped-slot counts of the MoE calls made while `record_drops` is
# open (device scalars, read when it closes); None when closed
_drop_log: Optional[list] = None


@contextlib.contextmanager
def record_drops():
    """Collect the slots each `moe_apply` / `moe_apply_expert_parallel`
    call drops while open: yields a list that holds, once the block
    closes, one int per call (this process's own dispatch, on a mesh). The
    counts stay on the device until then: no host read inside a step."""
    global _drop_log
    outer, _drop_log = _drop_log, []
    log = _drop_log
    try:
        yield log
    finally:
        _drop_log = outer
        log[:] = [int(n) for n in log]


def _log_drops(keep) -> None:
    if _drop_log is not None:
        _drop_log.append((~keep).sum())


def _moe(cfg: ArchConfig, p: dict, x, cap: int):
    """The routed FFN of ``x`` (B, S, d) at ``cap`` slots an expert, the
    side MLPs added. Returns (out, flat_e, probs)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e = m.n_experts
    xf = x.reshape(n, d)

    logits = xf.to(torch.float32) @ p["router"]
    idx, wts, probs = _route(m, logits)
    flat_e, order, tok, keep, dest = _dispatch(m, idx, cap)
    _log_drops(keep)
    buf = _scatter(xf, tok, dest, e * cap).reshape(e, cap, d)
    y = _experts(cfg, p, buf).reshape(e * cap, d)
    out = _combine(y, keep, dest, wts.reshape(-1)[order], tok, n)
    return _side_mlps(cfg, p, x, out.reshape(b, s, d)), flat_e, probs


def moe_apply(cfg: ArchConfig, p: dict, x) -> Tuple[torch.Tensor, dict]:
    """Returns (out, aux): aux carries the Switch load-balance loss
    ``E · Σ_e f_e · P_e · coef``. Capacity is per call:
    ``cap = round(N·k/E·capacity_factor)`` slots an expert."""
    m = cfg.moe
    n = x.shape[0] * x.shape[1]
    e, k = m.n_experts, m.top_k
    out, flat_e, probs = _moe(cfg, p, x, _capacity(m, n))
    f = _load(flat_e, e, n * k)
    aux = e * torch.sum(f * probs.mean(0)) * m.router_aux_coef
    return out, {"moe_aux_loss": aux}


def moe_apply_slots(cfg: ArchConfig, p: dict, x):
    """The MoE FFN of a serving decode tick: ``x`` (slots, 1, d), one token
    a slot, each slot dispatched as a group of its own, as the reference's
    `decode_slots` gives it (it vmaps the model over the slots, so its
    `moe_apply` sees N = 1 and ``cap = max(1, round(k/E·cf))``). A
    one-token group sends its k picks to k distinct experts and never
    drops, so one batched dispatch at ``cap = slots`` (no expert can get
    more) keeps every pick too and computes the same rows. `moe_apply` on
    the batch would instead share ``round(slots·k/E·cf)`` slots an expert
    among the slots and drop picks the reference keeps."""
    if x.shape[1] != 1:
        raise ValueError(f"moe_apply_slots takes one token a slot, got "
                         f"{tuple(x.shape)}")
    return _moe(cfg, p, x, x.shape[0])[0]


def dropped_slots(cfg: ArchConfig, p: dict, x) -> int:
    """How many (token, pick) slots `moe_apply` drops on ``x`` at the
    config's capacity factor (a host count)."""
    m = cfg.moe
    n = x.shape[0] * x.shape[1]
    logits = x.reshape(n, -1).to(torch.float32) @ p["router"]
    idx, _, _ = _route(m, logits)
    keep = _dispatch(m, idx, _capacity(m, n))[3]
    return int((~keep).sum())


def moe_apply_expert_parallel(cfg: ArchConfig, p: dict, x, ctx: ShardCtx,
                              aux: bool = True):
    """The MoE FFN on one process of a (data, model) mesh (``ctx``), with
    a backward. ``x`` (B/n_data, S, d) is this replica's rows and ``p``
    this process's shards as `sharding.specs.place` leaves them
    (`moe_specs`): the whole router, experts ``[rank·E/n, (rank+1)·E/n)``
    of the stacked expert weights, and its Megatron shards of the shared
    expert (llama4) and the dense residual FFN (arctic). Returns (out, aux)
    as `moe_apply`: this replica's rows, and the aux loss, equal on every
    process.

    As the reference's shard_map: the replica's tokens are padded to a
    multiple of ``n_model`` and the process dispatches its share of them
    (capacity per (process, expert), one more slot when padded: a decode
    of fewer tokens than ranks); one all-to-all over ``model`` carries
    each expert's slots to its owner and one brings the outputs back; an
    all-gather over ``model`` rebuilds the replica's rows. The load
    fractions and mean probabilities are averaged over every process
    (`core.collectives.mesh_mean`, whose adjoint gives the global loss's
    gradient); ``aux=False`` (prefill and decode, which read no aux loss)
    skips them and their two all-reduces, as the reference's compiled
    serving step drops the unused ``pmean``s, and gives an aux of 0.
    ``x`` and the router enter the tensor-parallel region
    (`ShardCtx.enter`): each rank's gradient of them covers its own
    tokens, summed over ``model``. The shared expert and the dense
    residual are `mlp_apply` on the mesh (rank-local, reduced over
    ``model``)."""
    from repro_torch.core import collectives as C

    m, mesh = cfg.moe, ctx.mesh
    b, s, d = x.shape
    tp = mesh.n_model
    e, k = m.n_experts, m.top_k
    el = p["w_up"].shape[0]
    if el * tp != e:
        raise ValueError(
            f"{cfg.arch_id}: {e} experts do not split over {tp} model ranks "
            f"(this process holds {el}); the reference's shard_map refuses "
            "the layout too")
    n_rep = b * s
    n_pad = (-n_rep) % tp
    n_loc = (n_rep + n_pad) // tp
    cap = int(max(1, round(n_loc * k / e * m.capacity_factor)
                  + (1 if n_pad else 0)))

    xf = ctx.enter(x).reshape(n_rep, d)
    if n_pad:
        xf = torch.cat([xf, xf.new_zeros((n_pad, d))])
    mine = xf[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]

    logits = mine.to(torch.float32) @ ctx.enter(p["router"])
    idx, wts, probs = _route(m, logits)
    flat_e, order, tok, keep, dest = _dispatch(m, idx, cap)
    _log_drops(keep)
    buf = _scatter(mine, tok, dest, e * cap)                # (E·cap, d)
    # out to the owners: peer j gets experts [j·el, (j+1)·el)
    split = [el * cap] * tp
    got = C.all_to_all(buf, split, split, mesh.model)       # (tp·el·cap, d)
    got = got.reshape(tp, el, cap, d).transpose(0, 1).reshape(el, tp * cap, d)
    y = _experts(cfg, p, got)
    # and back: peer j's slots return to peer j
    y = y.reshape(el, tp, cap, d).transpose(0, 1).reshape(tp * el * cap, d)
    y = C.all_to_all(y, split, split, mesh.model).reshape(e * cap, d)
    out = _combine(y, keep, dest, wts.reshape(-1)[order], tok, n_loc)

    full = C.gather_from_model(out, mesh.model, mesh.rank)[:n_rep]
    out = _side_mlps(cfg, p, x, full.reshape(b, s, d), ctx)

    if not aux:
        return out, {"moe_aux_loss": 0.0}
    stats = C.mesh_mean(torch.stack([_load(flat_e, e, n_loc * k),
                                     probs.mean(0)]), mesh)
    return out, {"moe_aux_loss": e * torch.sum(stats[0] * stats[1])
                 * m.router_aux_coef}


def moe_apply_dense_ref(cfg: ArchConfig, p: dict, x):
    """O(E·N) oracle: every expert processes every token, masked combine
    (no capacity, so tests pick a capacity factor at which nothing
    drops)."""
    m = cfg.moe
    b, s, d = x.shape
    act = act_fn(cfg.ffn_act)
    xf = x.reshape(-1, d)
    logits = xf.to(torch.float32) @ p["router"]
    idx, wts, _ = _route(m, logits)
    h = torch.einsum("nd,edf->enf", xf, p["w_up"])
    if cfg.ffn_gated:
        h = act(torch.einsum("nd,edf->enf", xf, p["w_gate"])) * h
    else:
        h = act(h)
    y = torch.einsum("enf,efd->end", h, p["w_down"])           # (E, N, d)
    onehot = torch.nn.functional.one_hot(idx, m.n_experts).to(torch.float32)
    w_e = (onehot * wts[..., None]).sum(1)                     # (N, E)
    out = torch.einsum("end,ne->nd", y.to(torch.float32), w_e).to(x.dtype)
    return _side_mlps(cfg, p, x, out.reshape(b, s, d))
