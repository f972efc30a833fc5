"""NTP training of the prototype transformer (port of
`repro/core/ntp_train.py`, dense MLP or MoE, pp >= 1).

The reference computes transformer layers under nonuniform tensor
parallelism inside shard_map over a (data=D, model=n1) mesh. The port
emulates that mesh on one device:

* every TP-sharded (unit) weight keeps the reference's packed layout
  ``(D, n1*buf, *unit)``, one tensor holding every (replica, rank) buffer; a
  degraded replica holds all units on its first n_r ranks, failed ranks
  hold zeros (algebraically inert — their gradients are exact zeros);
* replicated leaves (embed, head, final_norm, ln1, ln2, and the MoE
  router) are held ONCE, as one logical copy;
* the forward computes every (replica, rank) partial sum batched over the
  replica and rank dims; ``psum('model')`` is a sum over the rank dim, and
  the global loss divides the summed token losses of all replicas by
  ``max(count, 1)`` — one autograd graph, the reference's "AD outside
  shard_map". Replicated-leaf gradients therefore come out already summed,
  and unit-leaf gradients come out per replica: the pre-sync local
  gradients;
* gradient sync is reshard → sum over the replica dim (``psum('data')``) →
  reshard (`core.reshard`, through the `reshard_pack` kernel), or the
  overlapped bucketed sync of `core.overlap` (``overlap=True``).

Nonuniform pipeline parallelism (a `StagedPlan`): the layers split into
``pp`` contiguous stages (`configs.shapes.stage_boundaries`), each packed
and synced under its own stage's `FailurePlan`, so a degraded stage packs
wider buffers while a healthy one stays tight. As in the reference's
emulated step, every rank plays each stage in turn: the layer loop is the
pipeline, and ``microbatches`` chunks of the local batch walk it one after
another, their token-loss totals summed before the one normalization. The
1F1B bubble is analytic (`core.perf_model`), not measured.

The process path (`make_rank_train_step`, on a `launch.mesh.RankMesh`)
runs the reference's shard_map body for real: one process per (replica,
rank) holds its own ``(buf, *unit)`` slots (`pack_rank_params`) and the
replicated leaves, ``psum('model')`` is an all-reduce over the model group
wrapped in the Megatron pair (`core.collectives`), and autograd runs per
rank. Each rank's loss for autograd is its replica's token-loss total over
the GLOBAL count (totals and counts summed over ``data``, as the reference
sums them), so its gradients are its replica's share of the global
gradient; the sync (`core.overlap.make_sync_grads` on the mesh, or the
overlapped bucketed one of `core.overlap.make_overlapped_rank_train_step`)
sums them over ``data``.

Pipeline parallelism on process groups takes one of the reference's two
routes, chosen by the mesh alone (`make_ntp_train_step`): on a 2-D
`RankMesh` every process holds every layer, each packed under its own
stage's plan, and walks the microbatches through the layers one after
another (the stage-sequential step); on a staged mesh
(`launch.mesh.make_staged_mesh`) each process holds its own stage's layers
only and the step is `core.pp_submesh.make_submesh_train_step`, a real
pipeline with the activations handed between stages.

MoE (``n_experts > 0``, DESIGN.md §4): the partition unit of the FFN is
the whole expert, so ``A``/``B`` are expert-shaped ``(E, d, d_ff)`` /
``(E, d_ff, d)`` and a lost rank's experts are re-placed by Algorithm 1
like any other unit. Every rank computes its slots' experts on every token
(the reference's dense-masked prototype form, `_moe_local`), each gated by
the replicated ``router``'s renormalised top-k softmax; a slot's expert id
is its plan's ``comp_slots`` entry and a pad slot (-1) gets gate 0. On the
process path the router sits inside the Megatron pair, so each rank's
router gradient holds its own experts' gates only: the rank syncs sum it
over ``model`` and ``data`` (``ln1``/``ln2`` over ``data`` only).

Also the DP-DROP baseline and a dense single-logical-copy reference
(`make_reference_loss`) for the equivalence tests.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tr
from repro_torch.configs.shapes import layer_stages, stage_boundaries
from repro_torch.core import collectives as C
from repro_torch.core import nonuniform as nu
from repro_torch.kernels import mode as kmode
from repro_torch.launch.mesh import RankMesh
from repro_torch.optim.base import Optimizer, sgd


class Mode(enum.Enum):
    """Gradient-synchronization regime of one training job.

    UNIFORM  — every replica healthy; plain DP all-reduce.
    NTP      — nonuniform TP: reshard → psum('data') → reshard sync.
    DP_DROP  — baseline: replicas containing a failure contribute nothing.
    """

    UNIFORM = "uniform"
    NTP = "ntp"
    DP_DROP = "dpdrop"

    @classmethod
    def coerce(cls, v: Union["Mode", str]) -> "Mode":
        if isinstance(v, Mode):
            return v
        return cls(str(v).lower().replace("-", "").replace("_", ""))


@dataclass(frozen=True)
class NTPModelConfig:
    """The prototype transformer (paper §5.1): attention whose partition
    unit is the GQA kv-group, and a two-matrix GELU MLP whose unit is a
    block of ``unit_rows`` hidden rows — or, with ``n_experts > 0``, a
    top-``top_k`` MoE of two-matrix GELU experts whose unit is the whole
    expert (DESIGN.md §4)."""

    d_model: int = 256
    n_kv_groups: int = 8          # attention partition units
    q_per_kv: int = 2
    head_dim: int = 32
    d_ff: int = 1024
    unit_rows: int = 128          # MLP partition unit
    n_layers: int = 2
    vocab: int = 512
    n_experts: int = 0            # 0 = dense MLP
    top_k: int = 2

    def __post_init__(self):
        if self.is_moe:
            if not 1 <= self.top_k <= self.n_experts:
                raise ValueError(f"top_k={self.top_k} outside [1, "
                                 f"n_experts={self.n_experts}]")
        elif self.d_ff % self.unit_rows:
            raise ValueError(
                f"d_ff={self.d_ff} is not a multiple of unit_rows="
                f"{self.unit_rows}")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def k_ff(self) -> int:
        """FFN partition units: whole experts (MoE) or row blocks."""
        if self.is_moe:
            return self.n_experts
        return self.d_ff // self.unit_rows

    @property
    def ffu(self) -> int:
        """Hidden rows of one FFN unit."""
        return self.d_ff if self.is_moe else self.unit_rows


UNIT_KEYS = ("wq", "wk", "wv", "wo", "A", "B")
TOP_KEYS = ("embed", "final_norm", "head")
# a layer's replicated leaves: its norms, and the router of an MoE layer
REP_KEYS = ("ln1", "ln2", "router")


# ---------------------------------------------------------------------------
# canonical (dense) params + packing

def stage_share(cfg: NTPModelConfig, pp: int, stage: Optional[int]):
    """(layer ids, top-level keys) a process of pipeline stage ``stage``
    holds on a staged mesh: its stage's layers, ``embed`` on stage 0, and
    ``final_norm`` and ``head`` on the last stage. ``stage=None`` (or
    pp=1) is every layer and every key."""
    if stage is None or pp == 1:
        return range(cfg.n_layers), TOP_KEYS
    b = stage_boundaries(cfg.n_layers, pp)
    top = (("embed",) if stage == 0 else ()) + \
        (("final_norm", "head") if stage == pp - 1 else ())
    return range(b[stage], b[stage + 1]), top


def init_canonical(cfg: NTPModelConfig, generator: torch.Generator = None,
                   *, device=None, pp: int = 1,
                   stage: Optional[int] = None) -> Dict:
    """Random canonical weights drawn from ``generator`` on ``device`` (CUDA
    unless ``device="cpu"``), at the reference's scales. Tests that compare
    with the reference feed it the reference's own values instead
    (`convert.ntp_params_from_jax`).

    With ``stage`` only that stage's share (`stage_share`) is kept: every
    leaf is still drawn, in the same order, so the kept values equal the
    whole tree's, and each other leaf is dropped as soon as it is drawn
    (absent top-level keys; ``{}`` for another stage's layer)."""
    dev = kmode.resolve_device(device)
    own, top = stage_share(cfg, pp, stage)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    d, g, q, h = cfg.d_model, cfg.n_kv_groups, cfg.q_per_kv, cfg.head_dim

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def layer():
        s = d ** -0.5
        p = {
            "ln1": ones(d),
            "ln2": ones(d),
            "wq": randn(g, d, q * h, scale=s),
            "wk": randn(g, d, h, scale=s),
            "wv": randn(g, d, h, scale=s),
            "wo": randn(g, q * h, d, scale=(q * h) ** -0.5),
            "A": randn(cfg.k_ff, d, cfg.ffu, scale=s),
            "B": randn(cfg.k_ff, cfg.ffu, d, scale=cfg.d_ff ** -0.5),
        }
        if cfg.is_moe:
            p["router"] = randn(d, cfg.n_experts, scale=s)
        return p

    out = {}
    for key, draw in (("embed", lambda: randn(cfg.vocab, d, scale=0.02)),
                      ("head", lambda: randn(d, cfg.vocab, scale=d ** -0.5)),
                      ("final_norm", lambda: ones(d))):
        leaf = draw()
        if key in top:
            out[key] = leaf
        del leaf
    layers = []
    for i in range(cfg.n_layers):
        lp = layer()
        layers.append(lp if i in own else {})
        del lp
    out["layers"] = layers
    return out


def canonical_like(cfg: NTPModelConfig, dtype=torch.float32) -> Dict:
    """``meta`` tensors of the canonical tree's shapes (no memory)."""
    d, g, q, h = cfg.d_model, cfg.n_kv_groups, cfg.q_per_kv, cfg.head_dim

    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    def layer():
        p = {"ln1": t(d), "ln2": t(d), "wq": t(g, d, q * h),
             "wk": t(g, d, h), "wv": t(g, d, h), "wo": t(g, q * h, d),
             "A": t(cfg.k_ff, d, cfg.ffu), "B": t(cfg.k_ff, cfg.ffu, d)}
        if cfg.is_moe:
            p["router"] = t(d, cfg.n_experts)
        return p

    return {"embed": t(cfg.vocab, d), "head": t(d, cfg.vocab),
            "final_norm": t(d),
            "layers": [layer() for _ in range(cfg.n_layers)]}


def _plans(cfg: NTPModelConfig, fplan: nu.FailurePlan):
    return {
        "attn": nu.weight_plan(cfg.n_kv_groups, fplan),
        "mlp": nu.weight_plan(cfg.k_ff, fplan),
    }


def _layer_plans(cfg: NTPModelConfig, fplan):
    """Per-layer {attn, mlp} weight plans. A plain `FailurePlan` (pp=1)
    gives every layer the same (cached) plans; a `StagedPlan` gives each
    layer its OWN stage's plans, so a layer's buffers are packed for exactly
    the scale-up domain that computes it."""
    staged = nu.as_staged(fplan)
    if staged.pp == 1:
        return [_plans(cfg, staged.stages[0])] * cfg.n_layers
    per_stage = [_plans(cfg, p) for p in staged.stages]
    return [per_stage[s] for s in layer_stages(cfg.n_layers, staged.pp)]


def _slot_index(wp: nu.WeightPlan, d: int, device):
    """(flat packed slot positions, canonical unit ids) of replica d."""
    sl = wp.comp_slots[d].reshape(-1)
    pos = np.nonzero(sl >= 0)[0]
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(sl[pos], device=device))


def _pack_unit(w: torch.Tensor, wp: nu.WeightPlan) -> torch.Tensor:
    """Canonical unit-major weight (k, *unit) -> (D, n1*buf, *unit), built
    as a fresh tensor (pad slots zero)."""
    d, n1, buf = wp.comp_slots.shape
    out = w.new_zeros((d, n1 * buf) + tuple(w.shape[1:]))
    for dd in range(d):
        pos, uid = _slot_index(wp, dd, w.device)
        out[dd].index_copy_(0, pos, w.index_select(0, uid))
    return out


def _unpack_unit(w: torch.Tensor, wp: nu.WeightPlan,
                 replica: int) -> torch.Tensor:
    """Replica ``replica``'s buffers ``w`` (n1*buf, *unit) -> canonical
    (k, *unit)."""
    pos, uid = _slot_index(wp, replica, w.device)
    out = w.new_zeros((wp.k,) + tuple(w.shape[1:]))
    out.index_copy_(0, uid, w.index_select(0, pos))
    return out


def _rep_copy(lp) -> Dict:
    """Fresh copies of a layer's replicated leaves."""
    return {k: lp[k].clone() for k in REP_KEYS if k in lp}


def pack_params(cfg: NTPModelConfig, canonical: Dict, fplan) -> Dict:
    """Canonical -> packed unit buffers under ``fplan`` (a `FailurePlan`, or
    a `StagedPlan` whose stages pack their own layers). Every leaf of the
    result is a fresh tensor (replicated leaves are copied)."""
    lplans = _layer_plans(cfg, fplan)
    with torch.no_grad():
        out = {k: canonical[k].clone() for k in ("embed", "head", "final_norm")}
        out["layers"] = []
        for lp, plans in zip(canonical["layers"], lplans):
            layer = _rep_copy(lp)
            for k in UNIT_KEYS:
                wp = plans["mlp"] if k in ("A", "B") else plans["attn"]
                layer[k] = _pack_unit(lp[k], wp)
            out["layers"].append(layer)
    return out


def unpack_params(cfg: NTPModelConfig, packed: Dict, fplan,
                  replica: int = 0) -> Dict:
    """Packed -> canonical weights as held by ``replica``."""
    lplans = _layer_plans(cfg, fplan)
    with torch.no_grad():
        out = {k: packed[k].clone() for k in ("embed", "head", "final_norm")}
        out["layers"] = []
        for lp, plans in zip(packed["layers"], lplans):
            layer = _rep_copy(lp)
            for k in UNIT_KEYS:
                wp = plans["mlp"] if k in ("A", "B") else plans["attn"]
                layer[k] = _unpack_unit(lp[k][replica], wp, replica)
            out["layers"].append(layer)
    return out


def _kind(key: str) -> str:
    return "mlp" if key in ("A", "B") else "attn"


def _rank_stage(mesh):
    """The stage a process of ``mesh`` holds alone (staged mesh), else None
    (a 2-D mesh: every layer)."""
    return mesh.stage if getattr(mesh, "pp", 1) > 1 else None


def pack_rank_params(cfg: NTPModelConfig, canonical: Dict, plan,
                     replica: int, rank: int,
                     stage: Optional[int] = None) -> Dict:
    """Canonical -> the packed tree of one (replica, rank) process: unit
    leaves ``(buf, *unit)``, equal to slice ``[replica, rank]`` of
    `pack_params`' ``(D, n1, buf, *unit)`` view; replicated leaves copied.
    A failed rank holds only pad slots (zeros). Under a `StagedPlan` each
    layer packs under its own stage's plan; with ``stage`` (a process of a
    staged mesh) only that stage's share is packed (`stage_share`: other
    layers are ``{}``), and ``canonical`` needs to hold only that share."""
    lplans = _layer_plans(cfg, plan)
    own, top = stage_share(cfg, nu.as_staged(plan).pp, stage)
    with torch.no_grad():
        out = {k: canonical[k].clone() for k in top}
        out["layers"] = []
        for li, plans in enumerate(lplans):
            if li not in own:
                out["layers"].append({})
                continue
            lp = canonical["layers"][li]
            layer = _rep_copy(lp)
            for k in UNIT_KEYS:
                wp = plans[_kind(k)]
                sl = wp.comp_slots[replica, rank]
                pos = np.nonzero(sl >= 0)[0]
                w = lp[k]
                layer[k] = w.new_zeros((wp.buf,) + tuple(w.shape[1:]))
                layer[k].index_copy_(
                    0, torch.as_tensor(pos, device=w.device),
                    w.index_select(0, torch.as_tensor(sl[pos], device=w.device)))
            out["layers"].append(layer)
    return out


def _owner(path, stage_of, pp: int) -> int:
    """The pipeline stage holding a canonical leaf."""
    if path[0] == "layers":
        return stage_of[path[1]]
    return 0 if path[0] == "embed" else pp - 1


def rank_canonical_leaves(cfg: NTPModelConfig, packed: Dict, plan,
                          mesh: RankMesh, device=None):
    """This process's canonical weights from its packed tree, one
    ``(path, leaf)`` at a time in flatten order: every unit leaf is
    gathered over the replica's model group (a collective: every process of
    the replica walks the leaves together). Each leaf lands on ``device``
    (default: where it lies) as soon as it is gathered, so a caller that
    drops each leaf holds one at a time. On a staged mesh these are the
    process's own stage's leaves only, with no traffic between stages
    (`staged_canonical_leaves` walks the whole tree)."""
    lplans = _layer_plans(cfg, plan)
    with torch.no_grad():
        for path, w in tr.leaves_with_path(packed):
            key = tr.leaf_key(path)
            dev = w.device if device is None else device
            if key not in UNIT_KEYS:
                yield path, w.detach().to(dev, copy=True)
                continue
            wp = lplans[path[1]][_kind(key)]
            g = C.all_gather_units(w.detach(), mesh.model)
            leaf = _unpack_unit(g.reshape((-1,) + tuple(w.shape[1:])),
                                wp, mesh.replica).to(dev)
            del g
            yield path, leaf


def staged_canonical_leaves(cfg: NTPModelConfig, packed: Dict, plan,
                            mesh: RankMesh, device=None):
    """`rank_canonical_leaves` over the whole canonical tree on a staged
    mesh: the owning stage gathers a leaf and broadcasts it over ``stage``
    (on the CPU when ``device`` is the CPU and the backend gloo), so every
    process of the replica yields every leaf, in flatten order."""
    stage_of = layer_stages(cfg.n_layers, mesh.pp)
    own = rank_canonical_leaves(cfg, packed, plan, mesh, device)
    dev = mesh.device if device is None else torch.device(device)
    bdev = dev if mesh.backend == "gloo" else mesh.device
    like = canonical_like(cfg, tr.leaves(packed)[0].dtype)
    with torch.no_grad():
        for path, w in tr.leaves_with_path(like):
            src = _owner(path, stage_of, mesh.pp)
            if src == mesh.stage:
                mine, leaf = next(own)
                assert mine == path, (mine, path)
                leaf = leaf.to(bdev)
            else:
                leaf = torch.empty(w.shape, dtype=w.dtype, device=bdev)
            yield path, C.broadcast_stage_(leaf, src, mesh).to(dev)
        # run the own walk to its end: its no_grad exits before this one's
        assert next(own, None) is None


def unpack_rank_params(cfg: NTPModelConfig, packed: Dict, plan,
                       mesh: RankMesh, device=None) -> Dict:
    """This process's replica's canonical weights from its packed tree
    (`rank_canonical_leaves` collected; a collective of the replica, and on
    a staged mesh of the replica's processes of every stage,
    `staged_canonical_leaves`). With ``device`` the CPU the card holds one
    gathered leaf at a time."""
    staged = _rank_stage(mesh) is not None
    walk = staged_canonical_leaves if staged else rank_canonical_leaves
    out = tr.tree_map(lambda x: None, canonical_like(cfg) if staged else packed)
    for path, leaf in walk(cfg, packed, plan, mesh, device):
        tr.set_path(out, path, leaf)
    return out


def repack_params(cfg: NTPModelConfig, packed: Dict, old, new) -> Dict:
    """Re-express a packed tree under a new plan via the DIRECT
    packed→packed transition (`reshard.transition`); staged plans move each
    stage's layers under that stage's own plans."""
    if new == old:
        return packed
    if isinstance(old, nu.StagedPlan) or isinstance(new, nu.StagedPlan):
        from repro_torch.reshard.transition import transition_staged_trees

        (tree,), _ = transition_staged_trees(
            cfg, [packed], nu.as_staged(old), nu.as_staged(new))
        return tree
    from repro_torch.reshard.transition import transition_params

    tree, _ = transition_params(cfg, packed, old, new)
    return tree


# ---------------------------------------------------------------------------
# forward on the emulated mesh: unit leaves (D, n1*buf, *unit), activations
# (D, B, S, d); the dense reference is the same code at D = n1 = 1

def _rms(x, w):
    v = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(v + 1e-6) * w


def _ranks(w, n1: int):
    """(D, n1*buf, *unit) -> (D, n1, buf, *unit)."""
    return w.reshape(w.shape[0], n1, -1, *w.shape[2:])


def _attn_local(lp, h, cfg: NTPModelConfig, n1: int):
    """h: (D,B,S,d), one replica's activations per leading index; every rank
    computes its units' partial output, summed over ranks (psum('model'))."""
    dd, b, s, _ = h.shape
    q = torch.einsum("dbsm,dnumr->dnbsur", h, _ranks(lp["wq"], n1))
    k = torch.einsum("dbsm,dnumh->dnbsuh", h, _ranks(lp["wk"], n1))
    v = torch.einsum("dbsm,dnumh->dnbsuh", h, _ranks(lp["wv"], n1))
    u = q.shape[4]
    q = q.reshape(dd, n1, b, s, u, cfg.q_per_kv, cfg.head_dim)
    scores = torch.einsum("dnbsugh,dnbtuh->dnbugst", q, k) \
        * cfg.head_dim ** -0.5
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=h.device))
    # a Python scalar, not a device tensor built from one: building that
    # copies it to the device and makes the host wait, once per layer
    scores = torch.where(mask, scores.to(torch.float32), -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("dnbugst,dnbtuh->dnbsugh", probs.to(h.dtype), v)
    out = out.reshape(dd, n1, b, s, u, cfg.q_per_kv * cfg.head_dim)
    y = torch.einsum("dnbsur,dnurm->dnbsm", out, _ranks(lp["wo"], n1))
    return y.sum(dim=1)


def _mlp_local(lp, h, n1: int):
    a = F.gelu(torch.einsum("dbsm,dnumf->dnbsuf", h, _ranks(lp["A"], n1)),
               approximate="tanh")
    z = torch.einsum("dnbsuf,dnufm->dnbsm", a, _ranks(lp["B"], n1))
    return z.sum(dim=1)


def _gates(lp, h, cfg: NTPModelConfig):
    """(..., d) activations -> (..., E) f32 combine weights: the router's
    softmax, its top-k renormalised by ``max(sum, 1e-9)``, zero elsewhere."""
    logits = torch.einsum("...m,me->...e", h, lp["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return (F.one_hot(idx, cfg.n_experts).to(torch.float32)
            * w[..., None]).sum(-2)


def _moe_local(lp, h, uids, cfg: NTPModelConfig, n1: int):
    """The NTP-MoE FFN (partition unit = whole expert): every rank runs its
    slots' experts on all tokens, each weighted by its expert's gate, and
    the partial outputs sum over ranks (psum('model')). Pad slots hold
    zeros (gelu(0)·0 = 0) and get gate 0.

    h: (D,B,S,d); uids: (D, n1, U) global expert id per slot, -1 = pad.
    The id is clipped before the gather and masked after: an index of -1
    would read the last expert's gate."""
    gates = _gates(lp, h, cfg)                                  # (D,B,S,E)
    a = F.gelu(torch.einsum("dbsm,dnumf->dnbsuf", h, _ranks(lp["A"], n1)),
               approximate="tanh")
    y = torch.einsum("dnbsuf,dnufm->dnbsum", a, _ranks(lp["B"], n1))
    rows = torch.arange(h.shape[0], device=h.device)[:, None, None]
    gate_u = gates[rows, :, :, uids.clamp(min=0)]               # (D,n1,U,B,S)
    gate_u = (gate_u * (uids >= 0)[..., None, None]).permute(0, 1, 3, 4, 2)
    z = torch.einsum("dnbsum,dnbsu->dnbsm", y, gate_u.to(y.dtype))
    return z.sum(dim=1)


def _layer(lp, x, cfg: NTPModelConfig, n1: int, uids=None):
    """One transformer layer on the emulated mesh; ``uids`` are the MoE
    layer's (D, n1, U) slot ids."""
    x = x + _attn_local(lp, _rms(x, lp["ln1"]), cfg, n1)
    if cfg.is_moe:
        return x + _moe_local(lp, _rms(x, lp["ln2"]), uids, cfg, n1)
    return x + _mlp_local(lp, _rms(x, lp["ln2"]), n1)


_slot_tables: Dict[tuple, torch.Tensor] = {}


def _device_slots(slots: np.ndarray, device) -> torch.Tensor:
    """The int64 slot-id table ``slots`` on ``device``, kept per (table,
    device) for the process, as `_sample_masks` keeps its masks: a step
    does not copy it to the device every time."""
    key = (slots.shape, slots.tobytes(), str(device))
    if key not in _slot_tables:
        _slot_tables[key] = torch.as_tensor(slots, dtype=torch.int64,
                                            device=device)
    return _slot_tables[key]


def moe_slots(cfg: NTPModelConfig, plan, device):
    """Per-layer (D, n1, U) expert id of every (replica, rank, slot) under
    ``plan`` (each layer under its own stage's plan: ``plans["mlp"].
    comp_slots``, -1 = pad), on ``device``; ``None`` for a dense MLP."""
    if not cfg.is_moe:
        return None
    return [_device_slots(p["mlp"].comp_slots, device)
            for p in _layer_plans(cfg, plan)]


def rank_moe_slots(cfg: NTPModelConfig, plan, mesh: RankMesh, device):
    """`moe_slots` of one (replica, rank) process: per layer its (U,)
    slots' expert ids (``None`` for a dense MLP)."""
    slots = moe_slots(cfg, plan, device)
    return None if slots is None else \
        [t[mesh.replica, mesh.rank] for t in slots]


def _tail_totals(final_norm, head, x, tgt, sample_mask):
    """Per-replica (token-loss total, token count), each (D,)."""
    logits = torch.einsum("dbsm,mv->dbsv", _rms(x, final_norm), head)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tgt[..., None])[..., 0]
    tok_loss = (lse - ll) * sample_mask[..., None]
    count = (sample_mask[..., None] * torch.ones_like(tok_loss)).sum((1, 2))
    return tok_loss.sum((1, 2)), count


def _forward_totals(cfg: NTPModelConfig, params, tokens, sample_mask,
                    n1: int, uids=None):
    """One forward over all layers. tokens: (D, B, S+1) int64; sample_mask:
    (D, B) f32; uids: per-layer MoE slot ids (`moe_slots`). Returns the
    per-replica (D,) (token-loss total, count)."""
    inp, tgt = tokens[..., :-1], tokens[..., 1:]
    x = params["embed"][inp]
    for i, lp in enumerate(params["layers"]):
        x = _layer(lp, x, cfg, n1, None if uids is None else uids[i])
    return _tail_totals(params["final_norm"], params["head"], x, tgt,
                        sample_mask)


def _microbatch_totals(cfg: NTPModelConfig, params, tokens, sample_mask,
                       n1: int, microbatches: int, uids=None):
    """`_forward_totals` over ``microbatches`` chunks of the local batch
    walked one after another (the stage-sequential 1F1B emulation):
    microbatch j takes local rows [j*mb, (j+1)*mb) and the same columns of
    the mask — ``j*mb + arange(mb) < lb[d]``. Totals and counts accumulate
    before the one normalization, so the loss is the full-batch mean."""
    mb = tokens.shape[1] // microbatches
    total = count = None
    for j in range(microbatches):
        rows = slice(j * mb, (j + 1) * mb)
        t, c = _forward_totals(cfg, params, tokens[:, rows],
                               sample_mask[:, rows], n1, uids)
        total = t if total is None else total + t
        count = c if count is None else count + c
    return total, count


def _global_loss(totals, counts):
    """psum('data') of totals and counts, then the global mean."""
    return totals.sum() / torch.clamp(counts.sum(), min=1.0)


def _dense_view(canonical: Dict) -> Dict:
    """Canonical params seen as one replica with one rank holding every
    unit: unit leaves (k, *unit) -> (1, k, *unit)."""
    out = dict(canonical)
    out["layers"] = [
        {k: (v[None] if k in UNIT_KEYS else v) for k, v in lp.items()}
        for lp in canonical["layers"]
    ]
    return out


def make_reference_loss(cfg: NTPModelConfig):
    """Dense single-logical-copy loss on CANONICAL params — no ranks, no
    sync; the oracle for the NTP equivalence checks.

    loss(canonical_params, tokens (B,S+1), sample_mask (B,)) -> scalar.
    MoE: the one rank holds every expert, slot u holding expert u.
    """

    def loss(canonical, tokens, sample_mask):
        uids = None
        if cfg.is_moe:
            every = torch.arange(cfg.k_ff, device=canonical["embed"].device)
            uids = [every.reshape(1, 1, -1)] * cfg.n_layers
        totals, counts = _forward_totals(
            cfg, _dense_view(canonical), tokens.long()[None],
            sample_mask[None].to(torch.float32), 1, uids)
        return _global_loss(totals, counts)

    return loss


# ---------------------------------------------------------------------------
# forward on one (replica, rank) process: unit leaves (buf, *unit),
# activations (B, S, d); the local math is the emulated code at D = n1 = 1

def _rank_view(lp) -> Dict:
    return {k: (v[None] if k in UNIT_KEYS else v) for k, v in lp.items()}


def _attn_rank(lp, h, cfg: NTPModelConfig, group):
    """The attention block of one rank's kv-group slots, between the
    Megatron pair: its output is summed over the model group."""
    y = _attn_local(_rank_view(lp), C.copy_to_model(h, group)[None], cfg, 1)
    return C.reduce_from_model(y[0], group)


def _mlp_rank(lp, h, group):
    y = _mlp_local(_rank_view(lp), C.copy_to_model(h, group)[None], 1)
    return C.reduce_from_model(y[0], group)


def _moe_rank(lp, h, uids, cfg: NTPModelConfig, group):
    """The MoE FFN of one rank's expert slots ``uids`` (U,) on all tokens,
    between the Megatron pair. The router runs inside the pair, so this
    rank's router gradient comes from its own experts' gates only (the
    rank syncs sum it over ``model`` as well as ``data``)."""
    y = _moe_local(_rank_view(lp), C.copy_to_model(h, group)[None],
                   uids[None, None], cfg, 1)
    return C.reduce_from_model(y[0], group)


def _rank_layer(lp, x, cfg: NTPModelConfig, group, uids=None):
    """One transformer layer on one rank: x (B, S, d), replicated;
    ``uids`` the MoE layer's slot ids on this rank."""
    x = x + _attn_rank(lp, _rms(x, lp["ln1"]), cfg, group)
    if cfg.is_moe:
        return x + _moe_rank(lp, _rms(x, lp["ln2"]), uids, cfg, group)
    return x + _mlp_rank(lp, _rms(x, lp["ln2"]), group)


def _rank_tail(final_norm, head, x, tgt, sample_mask):
    """The replica's (token-loss total, token count), scalars, from the last
    layer's output x (B, S, d)."""
    total, count = _tail_totals(final_norm, head, x[None], tgt[None],
                                sample_mask[None])
    return total[0], count[0]


def _rank_tokens(batch, mesh: RankMesh, masks, device):
    """This rank's replica's rows of the global batch (int64 on ``device``)
    and their (B,) sample mask."""
    rows = batch.shape[0] // mesh.n_data
    d = mesh.replica
    tokens = torch.as_tensor(batch[d * rows:(d + 1) * rows],
                             device=device).long()
    return tokens, masks(rows, device)[d]


def _rank_totals(cfg: NTPModelConfig, params, tokens, sample_mask, group,
                 uids=None):
    """One rank's forward over its replica's local batch. tokens: (B, S+1)
    int64; sample_mask: (B,) f32; uids: per-layer MoE slot ids
    (`rank_moe_slots`). Returns the replica's (token-loss total, token
    count), scalars (every rank of the replica computes the same)."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = params["embed"][inp]
    for i, lp in enumerate(params["layers"]):
        x = _rank_layer(lp, x, cfg, group, None if uids is None else uids[i])
    return _rank_tail(params["final_norm"], params["head"], x, tgt,
                      sample_mask)


def _rank_microbatch_totals(cfg: NTPModelConfig, params, tokens, sample_mask,
                            group, microbatches: int, uids=None):
    """`_rank_totals` over ``microbatches`` chunks of the local batch walked
    one after another through every layer (the stage-sequential step, as
    `_microbatch_totals`), totals and counts summed."""
    mb = tokens.shape[0] // microbatches
    total = count = None
    for j in range(microbatches):
        rows = slice(j * mb, (j + 1) * mb)
        t, c = _rank_totals(cfg, params, tokens[rows], sample_mask[rows],
                            group, uids)
        total = t if total is None else total + t
        count = c if count is None else count + c
    return total, count


def rank_grad_norm(grads, mesh: RankMesh) -> torch.Tensor:
    """The global gradient norm from one rank's synced gradients: unit
    leaves summed over the model group (every replica holds the same synced
    units, so one replica's are counted), replicated leaves counted once.
    On a staged mesh each process holds its stage's leaves only, so the
    stages' squares are summed over ``stage``."""
    unit = rep = None
    for path, g in tr.leaves_with_path(grads):
        # no gradient-sized temporary (embed's and head's are GBs a rank)
        sq = torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
        if tr.leaf_key(path) in UNIT_KEYS:
            unit = sq if unit is None else unit + sq
        else:
            rep = sq if rep is None else rep + sq
    total = rep + C.psum(unit, mesh.model)
    if _rank_stage(mesh) is not None:
        total = C.psum_(total.reshape(1), mesh.pipe)[0]
    return torch.sqrt(total)


def make_rank_train_step(
    cfg: NTPModelConfig,
    fplan,
    mesh: RankMesh,
    *,
    mode: Union[Mode, str] = Mode.NTP,
    local_batch: int = 4,
    optimizer: Optional[Optimizer] = None,
    local_batches=None,
    microbatches: int = 1,
):
    """The step of one (replica, rank) process of a 2-D mesh, with the
    reference's contract ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` is this rank's packed tree
    (`pack_rank_params`), ``batch`` the GLOBAL (D*local_batch, S+1) token
    array, of which the rank takes its replica's rows. ``loss`` and
    ``grad_norm`` are the global ones, equal on every rank. The gradient
    sync is the sequential per-leaf one (`core.overlap.make_sync_grads` on
    the mesh).

    Under a `StagedPlan` (pp>1 on a 2-D mesh: the reference's
    stage-sequential step) every layer syncs under its own stage's plan and
    ``microbatches`` chunks of the local batch walk the layers one after
    another; the local batches follow the slowest stage."""
    if isinstance(fplan, nu.StagedPlan) and fplan.pp == 1:
        fplan = fplan.stages[0]
    if (fplan.d, fplan.n1) != tuple(mesh) or _rank_stage(mesh) is not None:
        raise ValueError(f"plan {fplan} does not fit the 2-D mesh "
                         f"{tuple(mesh)}")
    mode = Mode.coerce(mode)
    optimizer = optimizer or sgd(1e-2)
    validate_microbatches(microbatches, local_batch)
    masks = _sample_masks(_validated_local_batches(
        local_batches, fplan, mode, local_batch, fplan.d))

    def loss_and_grads(params, batch):
        """Global loss and this rank's pre-sync gradients: unit leaves its
        replica's share for its slots, replicated leaves its replica's
        share (the Megatron pair makes them equal over the model group)."""
        tokens, mask = _rank_tokens(batch, mesh, masks, mesh.device)
        leaves = _grad_leaves(params)
        total, count = _rank_microbatch_totals(
            cfg, leaves, tokens, mask, mesh.model, microbatches,
            rank_moe_slots(cfg, fplan, mesh, mesh.device))
        tc = C.psum(torch.stack([total.detach(), count]), mesh.data)
        denom = torch.clamp(tc[1], min=1.0)
        grads = torch.autograd.grad(total / denom, tr.leaves(leaves))
        return tc[0] / denom, _unflatten_like(leaves, grads)

    from repro_torch.core import overlap as ov

    sync_grads = ov.make_sync_grads(cfg, fplan, mode=mode, mesh=mesh)

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        grads = sync_grads(grads)
        params, opt_state, metrics = optimizer.update(
            grads, opt_state, params, grad_norm=rank_grad_norm(grads, mesh))
        return params, opt_state, dict(metrics, loss=loss)

    step.overlap = False
    step.collectives = sync_grads.collectives
    step.replicated_collectives = sync_grads.replicated_collectives
    step.grads_fn = loss_and_grads
    step.sync_fn = sync_grads
    return step


# ---------------------------------------------------------------------------
# train step builder

def _norm_weights(grads, d_axis: int):
    # packed unit buffers hold D identical copies of every synced unit
    # gradient: weight them 1/D so the global grad norm equals the
    # canonical-training norm exactly (replicated leaves are held once)
    return tr.tree_map_with_path(
        lambda path, _: 1.0 / d_axis if tr.leaf_key(path) in UNIT_KEYS
        else 1.0, grads)


def _validated_local_batches(local_batches, default_plan, mode, local_batch,
                             d_axis: int) -> np.ndarray:
    """The per-replica usable-sample table: the caller's override (bounds-
    checked) or the mode's default rule on ``default_plan``."""
    if local_batches is None:
        return default_local_batches(default_plan, mode, local_batch)
    lb = np.asarray(local_batches, dtype=np.int64)
    if lb.shape != (d_axis,):
        raise ValueError(f"local_batches {lb} is not one entry per replica "
                         f"({d_axis})")
    if not ((lb >= 0) & (lb <= local_batch)).all():
        raise ValueError(f"local_batches {lb} outside [0, {local_batch}]")
    return lb


def default_local_batches(fplan, mode: Union[Mode, str],
                          local_batch: int) -> np.ndarray:
    """Per-replica usable local batch implied by the mode alone: UNIFORM
    keeps the full batch, NTP shrinks ∝ surviving TP (paper §3.1), DP_DROP
    zeroes every replica containing a failure. A `StagedPlan` is reduced by
    its slowest stage (`StagedPlan.effective`): 1F1B runs every microbatch
    through every stage, so the most-degraded stage gates the replica."""
    if isinstance(fplan, nu.StagedPlan):
        fplan = fplan.effective
    mode = Mode.coerce(mode)
    if mode is Mode.NTP:
        return fplan.local_batch_fraction(local_batch)
    if mode is Mode.DP_DROP:
        return np.array([
            local_batch if t == fplan.n1 else 0 for t in fplan.replica_tp
        ])
    return np.array([local_batch] * fplan.d)


def validate_microbatches(microbatches: int, local_batch: int) -> None:
    """The staged builders' check: 1 <= microbatches <= local_batch, and
    microbatches divides local_batch."""
    if not 1 <= microbatches <= local_batch:
        raise ValueError(
            f"microbatches={microbatches} outside [1, local_batch={local_batch}]"
        )
    if local_batch % microbatches:
        raise ValueError(
            f"local_batch={local_batch} not divisible by "
            f"microbatches={microbatches}"
        )


def _split_batch(batch, d_axis: int, device):
    """Global tokens (D*B, S+1) -> (D, B, S+1) int64 on ``device``: replica
    d takes rows [d*B, (d+1)*B), as the reference's P('data') split."""
    tokens = torch.as_tensor(batch, device=device).long()
    return tokens.reshape(d_axis, -1, tokens.shape[-1])


def _sample_mask(lb: np.ndarray, b: int, device):
    return (torch.arange(b, device=device)[None, :]
            < torch.as_tensor(lb, device=device)[:, None]).to(torch.float32)


_masks: Dict[tuple, torch.Tensor] = {}


def _sample_masks(lb: np.ndarray):
    """``mask(b, device)``: the (D, b) sample mask of the static table
    ``lb``. Masks are kept per (table, b, device) for the process, so a
    step — and the steps rebuilt after a transition — does not copy the
    table to the device (and wait for the copy) every time."""
    table = tuple(int(x) for x in lb)

    def mask(b: int, device):
        key = (table, b, device)
        if key not in _masks:
            _masks[key] = _sample_mask(lb, b, device)
        return _masks[key]

    return mask


def _grad_leaves(params):
    """Fresh autograd leaves sharing the params' storage."""
    return tr.tree_map(lambda t: t.detach().requires_grad_(True), params)


def make_ntp_train_step(
    cfg: NTPModelConfig,
    fplan,
    mesh=None,
    *,
    mode: Union[Mode, str] = Mode.NTP,
    local_batch: int = 4,
    optimizer: Optional[Optimizer] = None,
    local_batches=None,
    microbatches: int = 1,
    overlap: bool = False,
):
    """Returns ``step`` with the reference's contract:

        step(params, opt_state, batch) -> (params, opt_state, metrics)

    ``batch`` is the global (D*local_batch, S+1) token array; ``metrics``
    carries at least ``loss`` and ``grad_norm``. ``params`` and
    ``opt_state`` are consumed (updated in place), as the reference's step
    donates them. ``mesh`` is the emulated (data, model) shape; it must
    match the plan when given.

    ``fplan`` may be a `StagedPlan` (nonuniform PP): each layer's gradients
    sync under its OWN stage's plan, and the forward runs stage-sequentially
    over ``microbatches`` chunks (`_make_staged_train_step`). A pp=1
    `StagedPlan` with ``microbatches=1`` takes the plain-plan path, so its
    step is the unstaged one.

    ``overlap=True`` switches to the overlapped, bucketed gradient sync
    (`core.overlap.make_overlapped_train_step`): the backward is layer-
    chunked and each chunk's bucket sync is issued while the previous
    chunk's backward runs. ``local_batches`` overrides the per-replica
    usable samples (bounds-checked); default is the mode's own rule.

    On a `launch.mesh.RankMesh` the step is this process's rank step, and
    the mesh alone picks the route, as the reference's dispatch: on a
    staged mesh (`core.pp_submesh.is_staged_mesh`) a `StagedPlan` or
    ``microbatches > 1`` runs the rank pipeline
    (`core.pp_submesh.make_submesh_train_step`, overlap swapping in the
    bucketed sync); on a 2-D mesh `make_rank_train_step` (sequential sync),
    or with ``overlap`` `core.overlap.make_overlapped_rank_train_step`, each
    taking a `StagedPlan` stage-sequentially."""
    if isinstance(mesh, RankMesh):
        from repro_torch.core import pp_submesh

        if isinstance(fplan, nu.StagedPlan) and fplan.pp == 1:
            fplan = fplan.stages[0]
        if pp_submesh.is_staged_mesh(mesh):
            pp_submesh.validate_staged_mesh(mesh, nu.as_staged(fplan).pp)
            return pp_submesh.make_submesh_train_step(
                cfg, nu.as_staged(fplan), mesh, mode=mode,
                local_batch=local_batch, optimizer=optimizer,
                local_batches=local_batches, microbatches=microbatches,
                overlap=overlap)
        if overlap:
            from repro_torch.core import overlap as ov

            build = ov.make_overlapped_rank_train_step
        else:
            build = make_rank_train_step
        return build(cfg, fplan, mesh, mode=mode, local_batch=local_batch,
                     optimizer=optimizer, local_batches=local_batches,
                     microbatches=microbatches)
    if isinstance(fplan, nu.StagedPlan) and fplan.pp == 1:
        fplan = fplan.stages[0]
    if mesh is not None and tuple(mesh) != (fplan.d, fplan.n1):
        raise ValueError(f"plan {fplan} does not fit mesh {tuple(mesh)}")
    staged = isinstance(fplan, nu.StagedPlan) or microbatches > 1
    if overlap:
        from repro_torch.core import overlap as ov

        return ov.make_overlapped_train_step(
            cfg, nu.as_staged(fplan) if staged else fplan, mode=mode,
            local_batch=local_batch, optimizer=optimizer,
            local_batches=local_batches, microbatches=microbatches)
    if staged:
        return _make_staged_train_step(
            cfg, nu.as_staged(fplan), mode=mode, local_batch=local_batch,
            optimizer=optimizer, local_batches=local_batches,
            microbatches=microbatches)
    return _build_step(cfg, fplan, Mode.coerce(mode), local_batch,
                       optimizer or sgd(1e-2), local_batches, 1)


def _make_staged_train_step(
    cfg: NTPModelConfig,
    staged: nu.StagedPlan,
    *,
    mode: Union[Mode, str] = Mode.NTP,
    local_batch: int = 4,
    optimizer: Optional[Optimizer] = None,
    local_batches=None,
    microbatches: int = 1,
):
    """Stage-aware twin of the plain step: the model is partitioned into
    ``staged.pp`` contiguous layer groups, each packed and synced under its
    own stage `FailurePlan`. The forward is microbatched stage-sequential —
    every microbatch walks the stages in order (on this emulation every
    rank plays each stage in turn); the 1F1B bubble ((pp-1)/m) is accounted
    analytically by `core.perf_model`, not by the clock. Gradient sync is
    STAGE-LOCAL: a failure in stage s moves no bytes for any other stage,
    and a healthy stage takes the plain sum while another is degraded. The
    local batches follow the slowest stage (`StagedPlan.effective`)."""
    validate_microbatches(microbatches, local_batch)
    return _build_step(cfg, staged, Mode.coerce(mode), local_batch,
                       optimizer or sgd(1e-2), local_batches, microbatches)


def _build_step(cfg, plan, mode: Mode, local_batch: int,
                optimizer: Optimizer, local_batches, microbatches: int):
    """The sequential step on a `FailurePlan` or `StagedPlan`: one autograd
    graph of the global loss (over ``microbatches`` chunks), then the
    shared sync body of `core.overlap.make_sync_grads`."""
    d_axis, n1 = plan.d, plan.n1
    lb = _validated_local_batches(local_batches, plan, mode, local_batch,
                                  d_axis)
    sample_mask = _sample_masks(lb)

    def loss_and_grads(params, batch):
        """Global loss and the pre-sync gradients (unit leaves per replica,
        replicated leaves summed) from one autograd graph."""
        dev = params["embed"].device
        tokens = _split_batch(batch, d_axis, dev)
        mask = sample_mask(tokens.shape[1], dev)
        leaves = _grad_leaves(params)
        loss = _global_loss(*_microbatch_totals(
            cfg, leaves, tokens, mask, n1, microbatches,
            moe_slots(cfg, plan, dev)))
        grads = torch.autograd.grad(loss, tr.leaves(leaves))
        return loss.detach(), _unflatten_like(leaves, grads)

    from repro_torch.core import overlap as ov

    sync_grads = ov.make_sync_grads(cfg, plan, mode=mode)

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        grads = sync_grads(grads)
        params, opt_state, metrics = optimizer.update(
            grads, opt_state, params, norm_weights=_norm_weights(grads, d_axis))
        return params, opt_state, dict(metrics, loss=loss)

    step.overlap = False
    step.collectives = sync_grads.collectives
    step.grads_fn = loss_and_grads
    step.sync_fn = sync_grads
    return step


def _unflatten_like(tree, flat):
    """A tree of ``tree``'s structure holding ``flat`` in flatten order."""
    paths = [p for p, _ in tr.leaves_with_path(tree)]
    out = tr.tree_map(lambda x: None, tree)
    for p, v in zip(paths, flat):
        tr.set_path(out, p, v)
    return out
