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
`moe_apply_expert_parallel` is the reference's expert-parallel form over a
`launch.mesh.RankMesh`: each process dispatches its share of its
replica's tokens and one all-to-all over the model group carries each
expert's slots to the process that owns the expert (and one back).
`moe_apply_dense_ref` (every expert on every token) is the oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.models.common import act_fn, dense_init


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


def mlp_apply(cfg: ArchConfig, p: dict, x):
    act = act_fn(cfg.ffn_act)
    h = x @ p["w_up"]
    if cfg.ffn_gated:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE

EXPERT_KEYS = ("w_up", "w_gate", "w_down")


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


def _route(m: MoESpec, logits):
    """(N, E) router logits -> (N, k) expert ids, f32 combine weights
    (renormalised over the k picks) and the (N, E) f32 probabilities."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)
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


def _side_mlps(cfg: ArchConfig, p: dict, x, out):
    if cfg.moe.shared_expert:
        out = out + mlp_apply(cfg, p["shared"], x)
    if cfg.moe.dense_residual:
        out = out + mlp_apply(cfg, p["dense"], x)
    return out


def moe_apply(cfg: ArchConfig, p: dict, x) -> Tuple[torch.Tensor, dict]:
    """Returns (out, aux): aux carries the Switch load-balance loss
    ``E · Σ_e f_e · P_e · coef``. Capacity is per call:
    ``cap = round(N·k/E·capacity_factor)`` slots an expert."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.n_experts, m.top_k
    cap = _capacity(m, n)
    xf = x.reshape(n, d)

    logits = xf.to(torch.float32) @ p["router"]
    idx, wts, probs = _route(m, logits)
    flat_e, order, tok, keep, dest = _dispatch(m, idx, cap)
    buf = _scatter(xf, tok, dest, e * cap).reshape(e, cap, d)
    y = _experts(cfg, p, buf).reshape(e * cap, d)
    out = _combine(y, keep, dest, wts.reshape(-1)[order], tok, n)
    out = _side_mlps(cfg, p, x, out.reshape(b, s, d))

    f = _load(flat_e, e, n * k)
    aux = e * torch.sum(f * probs.mean(0)) * m.router_aux_coef
    return out, {"moe_aux_loss": aux}


def dropped_slots(cfg: ArchConfig, p: dict, x) -> int:
    """How many (token, pick) slots `moe_apply` drops on ``x`` at the
    config's capacity factor (a host count)."""
    m = cfg.moe
    n = x.shape[0] * x.shape[1]
    logits = x.reshape(n, -1).to(torch.float32) @ p["router"]
    idx, _, _ = _route(m, logits)
    keep = _dispatch(m, idx, _capacity(m, n))[3]
    return int((~keep).sum())


def moe_apply_expert_parallel(cfg: ArchConfig, p: dict, x, mesh):
    """The expert-parallel MoE on one process of a (data, model)
    `launch.mesh.RankMesh` (forward only; the collectives are plain
    `torch.distributed` calls). ``x`` is the GLOBAL (B, S, d) batch, the
    same on every process, and ``p`` the whole MoE params (`moe_init`), of
    which the process computes with its ``E/n_model`` experts (rows
    ``[rank·E/n, (rank+1)·E/n)`` of the stacked expert weights), as the
    reference's shard_map slices them. Returns the global output and the
    aux loss, equal on every process.

    The process takes its replica's ``B/n_data`` rows, pads their tokens to
    a multiple of ``n_model`` and dispatches its share of them locally
    (capacity per (process, expert), one more slot when padded, as the
    reference); one all-to-all over the model group carries each expert's
    slots to its owner and one brings the outputs back; an all-gather over
    ``model`` rebuilds the replica's rows and one over ``data`` the batch.
    The load fractions and mean probabilities are averaged over every
    process. With ``B`` not divisible by ``n_data`` it is `moe_apply` on
    the whole batch, with no collective, as the reference falls back."""
    from repro_torch.core import collectives as C

    m = cfg.moe
    b, s, d = x.shape
    tp, dp = mesh.n_model, mesh.n_data
    if b % dp:
        return moe_apply(cfg, p, x)
    e, k = m.n_experts, m.top_k
    if e % tp:
        raise ValueError(f"{e} experts do not split over {tp} model ranks")
    bl = b // dp
    n_rep = bl * s
    n_pad = (-n_rep) % tp
    n_loc = (n_rep + n_pad) // tp
    cap = int(max(1, round(n_loc * k / e * m.capacity_factor)
                  + (1 if n_pad else 0)))

    xf = x[mesh.replica * bl:(mesh.replica + 1) * bl].reshape(n_rep, d)
    if n_pad:
        xf = torch.cat([xf, xf.new_zeros((n_pad, d))])
    mine = xf[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]

    logits = mine.to(torch.float32) @ p["router"]
    idx, wts, probs = _route(m, logits)
    flat_e, order, tok, keep, dest = _dispatch(m, idx, cap)
    buf = _scatter(mine, tok, dest, e * cap)                # (E·cap, d)
    # out to the owners: peer j gets experts [j·E/tp, (j+1)·E/tp)
    el = e // tp
    got = C.all_to_all_units(buf, [el * cap] * tp, [el * cap] * tp,
                             mesh.model)                   # (tp·el·cap, d)
    got = got.reshape(tp, el, cap, d).transpose(0, 1).reshape(el, tp * cap, d)
    own = slice(mesh.rank * el, (mesh.rank + 1) * el)
    y = _experts(cfg, {kk: p[kk][own] for kk in EXPERT_KEYS if kk in p}, got)
    # and back: peer j's slots return to peer j
    y = y.reshape(el, tp, cap, d).transpose(0, 1).reshape(tp * el * cap, d)
    y = C.all_to_all_units(y, [el * cap] * tp, [el * cap] * tp, mesh.model)
    y = y.reshape(tp, el, cap, d).reshape(e * cap, d)
    out = _combine(y, keep, dest, wts.reshape(-1)[order], tok, n_loc)

    rep = C.all_gather_units(out, mesh.model).reshape(-1, d)[:n_rep]
    full = C.all_gather_units(rep.reshape(bl, s, d), mesh.data)
    out = _side_mlps(cfg, p, x, full.reshape(b, s, d))

    stats = torch.stack([_load(flat_e, e, n_loc * k), probs.mean(0)])
    stats = C.psum_(C.psum_(stats, mesh.model), mesh.data) / (tp * dp)
    aux = e * torch.sum(stats[0] * stats[1]) * m.router_aux_coef
    return out, {"moe_aux_loss": aux}


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
