"""NTP training of the prototype transformer (port of
`repro/core/ntp_train.py` at pp=1, dense MLP).

The reference computes transformer layers under nonuniform tensor
parallelism inside shard_map over a (data=D, model=n1) mesh. The port
emulates that mesh on one device:

* every TP-sharded (unit) weight keeps the reference's packed layout
  ``(D, n1*buf, *unit)``, one tensor holding every (replica, rank) buffer; a
  degraded replica holds all units on its first n_r ranks, failed ranks
  hold zeros (algebraically inert — their gradients are exact zeros);
* replicated leaves (embed, head, final_norm, ln1, ln2) are held ONCE, as
  one logical copy;
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

Also the DP-DROP baseline and a dense single-logical-copy reference
(`make_reference_loss`) for the equivalence tests. MoE (`_moe_local`) and
pp>1 (`_make_staged_train_step`) wait for later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tr
from repro_torch.core import nonuniform as nu
from repro_torch.kernels import mode as kmode
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
    block of ``unit_rows`` hidden rows."""

    d_model: int = 256
    n_kv_groups: int = 8          # attention partition units
    q_per_kv: int = 2
    head_dim: int = 32
    d_ff: int = 1024
    unit_rows: int = 128          # MLP partition unit
    n_layers: int = 2
    vocab: int = 512
    n_experts: int = 0            # 0 = dense MLP (the only kind ported)

    def __post_init__(self):
        if self.n_experts > 0:
            raise NotImplementedError(
                "NTP MoE training (expert partition units, _moe_local) is "
                "not ported yet: ROADMAP Queue 1, 'MoE in the port's "
                "training path'"
            )
        if self.d_ff % self.unit_rows:
            raise ValueError(
                f"d_ff={self.d_ff} is not a multiple of unit_rows="
                f"{self.unit_rows}")

    @property
    def k_ff(self) -> int:
        return self.d_ff // self.unit_rows


UNIT_KEYS = ("wq", "wk", "wv", "wo", "A", "B")


# ---------------------------------------------------------------------------
# canonical (dense) params + packing

def init_canonical(cfg: NTPModelConfig, generator: torch.Generator = None,
                   *, device=None) -> Dict:
    """Random canonical weights drawn from ``generator`` on ``device`` (CUDA
    unless ``device="cpu"``), at the reference's scales. Tests that compare
    with the reference feed it the reference's own values instead
    (`convert.ntp_params_from_jax`)."""
    dev = kmode.resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    d, g, q, h = cfg.d_model, cfg.n_kv_groups, cfg.q_per_kv, cfg.head_dim

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def layer():
        s = d ** -0.5
        return {
            "ln1": ones(d),
            "ln2": ones(d),
            "wq": randn(g, d, q * h, scale=s),
            "wk": randn(g, d, h, scale=s),
            "wv": randn(g, d, h, scale=s),
            "wo": randn(g, q * h, d, scale=(q * h) ** -0.5),
            "A": randn(cfg.k_ff, d, cfg.unit_rows, scale=s),
            "B": randn(cfg.k_ff, cfg.unit_rows, d, scale=cfg.d_ff ** -0.5),
        }

    return {
        "embed": randn(cfg.vocab, d, scale=0.02),
        "head": randn(d, cfg.vocab, scale=d ** -0.5),
        "final_norm": ones(d),
        "layers": [layer() for _ in range(cfg.n_layers)],
    }


def _plans(cfg: NTPModelConfig, fplan: nu.FailurePlan):
    return {
        "attn": nu.weight_plan(cfg.n_kv_groups, fplan),
        "mlp": nu.weight_plan(cfg.k_ff, fplan),
    }


def _require_pp1(fplan) -> nu.FailurePlan:
    if isinstance(fplan, nu.StagedPlan):
        if fplan.pp != 1:
            raise NotImplementedError(
                "pipeline-parallel NTP training (pp>1) is not ported yet: "
                "ROADMAP Queue 1, 'pp>1 in the port'")
        return fplan.stages[0]
    return fplan


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
    pos, uid = _slot_index(wp, replica, w.device)
    out = w.new_zeros((wp.k,) + tuple(w.shape[2:]))
    out.index_copy_(0, uid, w[replica].index_select(0, pos))
    return out


def pack_params(cfg: NTPModelConfig, canonical: Dict, fplan) -> Dict:
    """Canonical -> packed unit buffers under ``fplan``. Every leaf of the
    result is a fresh tensor (replicated leaves are copied)."""
    plans = _plans(cfg, _require_pp1(fplan))
    with torch.no_grad():
        out = {k: canonical[k].clone() for k in ("embed", "head", "final_norm")}
        out["layers"] = []
        for lp in canonical["layers"]:
            layer = {"ln1": lp["ln1"].clone(), "ln2": lp["ln2"].clone()}
            for k in UNIT_KEYS:
                wp = plans["mlp"] if k in ("A", "B") else plans["attn"]
                layer[k] = _pack_unit(lp[k], wp)
            out["layers"].append(layer)
    return out


def unpack_params(cfg: NTPModelConfig, packed: Dict, fplan,
                  replica: int = 0) -> Dict:
    """Packed -> canonical weights as held by ``replica``."""
    plans = _plans(cfg, _require_pp1(fplan))
    with torch.no_grad():
        out = {k: packed[k].clone() for k in ("embed", "head", "final_norm")}
        out["layers"] = []
        for lp in packed["layers"]:
            layer = {"ln1": lp["ln1"].clone(), "ln2": lp["ln2"].clone()}
            for k in UNIT_KEYS:
                wp = plans["mlp"] if k in ("A", "B") else plans["attn"]
                layer[k] = _unpack_unit(lp[k], wp, replica)
            out["layers"].append(layer)
    return out


def repack_params(cfg: NTPModelConfig, packed: Dict, old: nu.FailurePlan,
                  new: nu.FailurePlan) -> Dict:
    """Re-express a packed tree under a new failure plan via the DIRECT
    packed→packed transition (`reshard.transition`)."""
    if new == old:
        return packed
    from repro_torch.reshard.transition import transition_params

    tree, _ = transition_params(cfg, packed, _require_pp1(old),
                                _require_pp1(new))
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


def _layer(lp, x, cfg: NTPModelConfig, n1: int):
    x = x + _attn_local(lp, _rms(x, lp["ln1"]), cfg, n1)
    return x + _mlp_local(lp, _rms(x, lp["ln2"]), n1)


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
                    n1: int):
    """One forward over all layers. tokens: (D, B, S+1) int64; sample_mask:
    (D, B) f32. Returns the per-replica (D,) (token-loss total, count)."""
    inp, tgt = tokens[..., :-1], tokens[..., 1:]
    x = params["embed"][inp]
    for lp in params["layers"]:
        x = _layer(lp, x, cfg, n1)
    return _tail_totals(params["final_norm"], params["head"], x, tgt,
                        sample_mask)


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
    """

    def loss(canonical, tokens, sample_mask):
        totals, counts = _forward_totals(
            cfg, _dense_view(canonical), tokens.long()[None],
            sample_mask[None].to(torch.float32), 1)
        return _global_loss(totals, counts)

    return loss


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
    zeroes every replica containing a failure."""
    mode = Mode.coerce(mode)
    if mode is Mode.NTP:
        return fplan.local_batch_fraction(local_batch)
    if mode is Mode.DP_DROP:
        return np.array([
            local_batch if t == fplan.n1 else 0 for t in fplan.replica_tp
        ])
    return np.array([local_batch] * fplan.d)


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

    ``overlap=True`` switches to the overlapped, bucketed gradient sync
    (`core.overlap.make_overlapped_train_step`): the backward is layer-
    chunked and each chunk's bucket sync is issued while the previous
    chunk's backward runs. ``local_batches`` overrides the per-replica
    usable samples (bounds-checked); default is the mode's own rule."""
    fplan = _require_pp1(fplan)
    if mesh is not None and tuple(mesh) != (fplan.d, fplan.n1):
        raise ValueError(f"plan {fplan} does not fit mesh {tuple(mesh)}")
    if microbatches != 1:
        raise NotImplementedError(
            "microbatched (1F1B) steps belong to pp>1, not ported yet: "
            "ROADMAP Queue 1, 'pp>1 in the port'")
    if overlap:
        from repro_torch.core import overlap as ov

        return ov.make_overlapped_train_step(
            cfg, fplan, mode=mode, local_batch=local_batch,
            optimizer=optimizer, local_batches=local_batches)
    mode = Mode.coerce(mode)
    optimizer = optimizer or sgd(1e-2)
    d_axis, n1 = fplan.d, fplan.n1
    lb = _validated_local_batches(local_batches, fplan, mode, local_batch,
                                  d_axis)
    sample_mask = _sample_masks(lb)

    def loss_and_grads(params, batch):
        """Global loss and the pre-sync gradients (unit leaves per replica,
        replicated leaves summed) from one autograd graph."""
        dev = params["embed"].device
        tokens = _split_batch(batch, d_axis, dev)
        mask = sample_mask(tokens.shape[1], dev)
        leaves = _grad_leaves(params)
        loss = _global_loss(*_forward_totals(cfg, leaves, tokens, mask, n1))
        grads = torch.autograd.grad(loss, tr.leaves(leaves))
        return loss.detach(), _unflatten_like(leaves, grads)

    from repro_torch.core import overlap as ov

    sync_grads = ov.make_sync_grads(cfg, fplan, mode=mode)

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
