"""Overlapped, bucketed gradient synchronization (port of
`repro/core/overlap.py`, pp >= 1).

* `make_sync_grads` is the one sync body of the step builders: stage-local
  NTP sync — each layer's unit grads reshard → psum('data') → reshard under
  its OWN stage's plan; a healthy stage takes the plain sum over replicas
  even while another stage is degraded, and no sync mixes stages. With
  ``bucketed=False`` it is the per-leaf route; with ``bucketed=True`` every
  unit leaf sharing a (stage, WeightPlan) is fused into one flat
  ``(rows, ΣE)`` buffer by the hand-written `bucket_pack` kernel before the
  sync and split by `bucket_unpack` after it. The rows are every emulated
  (replica, rank, slot) buffer row, so one launch packs a whole bucket. The
  fused buffer reshards under the per-leaf Algorithm-1 tables unchanged
  (they index unit rows only), so bucketed and sequential syncs agree
  exactly.

* `make_overlapped_train_step` chunks the backward on the
  `stage_boundaries` ladder (the stages at pp>1, so a bucket never
  straddles two; at most `DEFAULT_CHUNKS` chunks at pp=1): each chunk runs
  forward on a detached, grad-requiring input, and the backward runs chunk
  by chunk with `torch.autograd.grad`. Each chunk's bucket sync is ISSUED
  (pack + pre-sync reshard) on a second CUDA stream as soon as its grads
  exist and COMPLETED (sum over replicas + post-sync reshard + unpack)
  after the next chunk's backward has been issued — the reference's
  issue-L / complete-L+1 order, so the sync's kernels can run beside the
  backward's. Cross-stream use is made safe with `wait_stream` (the side
  stream waits for the grads it reads; the main stream waits for the synced
  grads before the optimizer) and `record_stream` (so the caching allocator
  does not hand a block to another stream while a kernel still reads it).

On a `launch.mesh.RankMesh` (one process per (replica, rank)) the same
order runs for real (`make_overlapped_rank_train_step`, on a 2-D mesh; its
chunks are the stages under a `StagedPlan`): a chunk's
unit buckets pack this rank's ``(buf, ΣE)`` slots with one `bucket_pack`
launch, reshard over the model group when degraded, and start an async
all-reduce over ``data`` (`collectives.psum_async_`); completing waits on
it, reshards back and unpacks with one `bucket_unpack` launch. Each chunk
also sums its ``ln1``/``ln2`` grads (and an MoE layer's ``router``) as one
rows-1 "rep bucket" over ``data``; ``embed``, ``head`` and ``final_norm``
are summed in place (no bucket copies GBs of ``embed``/``head``). The
Megatron pair already makes the norms' grads equal over ``model``, so the
reference's ``ct/n1`` seed and its ('data', 'model') psum stay unported
there too; the router runs inside the pair, so each rank's router grad is
its own experts' share and is first summed over ``model`` in place (the
reference reaches the same sum with its ('data', 'model') psum).

Emulation note — the ``ct/n1`` seed is NOT ported. The reference's
overlapped step runs AD *inside* shard_map, where jax transposes ``psum``
to ``psum``; it therefore seeds the cotangent ``ct/n1`` on every model rank
and psums replicated-leaf grads over ('data', 'model')
(`repro/core/overlap.py:29-45, :430`). The port's step is one autograd
graph of the global loss over every emulated rank (the reference's
"AD outside shard_map"): seeding ``ct/n1`` there would scale every
gradient by 1/n1, and its replicated leaves are held once, so their grads
come out already summed and the replicated "rep bucket" psum is the
identity. Only the unit buckets run the sync chain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.configs.shapes import layer_stages, stage_boundaries
from repro_torch.core import collectives as C
from repro_torch.core import nonuniform as nu
from repro_torch.core import ntp_train as nt
from repro_torch.core import reshard as rs
from repro_torch.kernels.bucket import bucket_pack, bucket_unpack
from repro_torch.optim.base import Optimizer, sgd

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_MLP_KEYS = ("A", "B")

# pp=1 backward chunk ladder: enough chunks to pipeline sync behind
# backward, few enough that each bucket stays worth a sync
DEFAULT_CHUNKS = 4


def coerce_overlap(v) -> bool:
    """CLI/config coercion: accepts bools and 'on'/'off' (+truthy spellings)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("on", "true", "1", "yes"):
        return True
    if s in ("off", "false", "0", "no"):
        return False
    raise ValueError(f"overlap must be on/off, got {v!r}")


def chunk_ranges(n_layers: int, pp: int) -> Tuple[Tuple[int, int], ...]:
    """The backward chunk ladder: the stage boundaries at pp>1, up to
    `DEFAULT_CHUNKS` even chunks at pp=1."""
    n = pp if pp > 1 else min(n_layers, DEFAULT_CHUNKS)
    b = stage_boundaries(n_layers, n)
    return tuple((b[i], b[i + 1]) for i in range(n) if b[i + 1] > b[i])


@dataclass(frozen=True)
class Bucket:
    """One fused sync group: every leaf in ``leaves`` shares ``stage``'s
    ``kind`` WeightPlan, so their row-aligned flats concatenate into one
    sync payload."""

    stage: int
    kind: str                            # "attn" | "mlp"
    leaves: Tuple[Tuple[int, str], ...]  # ((layer, key), ...)


def bucket_layout(cfg, staged, chunks=None) -> Tuple[Bucket, ...]:
    """One bucket per (chunk, plan-kind), in REVERSED chunk order (the
    backward produces the last chunk's grads first). ``chunks`` defaults to
    one chunk of every layer at pp=1."""
    staged = nu.as_staged(staged)
    stage_of = layer_stages(cfg.n_layers, staged.pp)
    if chunks is None:
        chunks = chunk_ranges(cfg.n_layers, staged.pp) if staged.pp > 1 else \
            ((0, cfg.n_layers),)
    out = []
    for lo, hi in reversed(tuple(chunks)):
        s = stage_of[lo]
        if any(stage_of[l] != s for l in range(lo, hi)):
            raise ValueError(f"chunk [{lo},{hi}) straddles stages {stage_of}")
        for kind, keys in (("attn", _ATTN_KEYS), ("mlp", _MLP_KEYS)):
            out.append(Bucket(s, kind,
                              tuple((l, k) for l in range(lo, hi)
                                    for k in keys)))
    return tuple(out)


def sync_collectives(cfg, staged, mode, *, bucketed: bool,
                     chunks=None) -> int:
    """Static count of collective launches one gradient sync performs. A
    degraded sync is reshard → psum → reshard = 3 launches; a healthy one is
    a single psum. Counted per unit bucket (bucketed) or per unit leaf."""
    staged = nu.as_staged(staged)
    mode = nt.Mode.coerce(mode)
    stage_of = layer_stages(cfg.n_layers, staged.pp)

    def cost(stage):
        degraded = mode is nt.Mode.NTP and not staged.stages[stage].healthy
        return 3 if degraded else 1

    if bucketed:
        return sum(cost(b.stage) for b in bucket_layout(cfg, staged, chunks))
    return sum(cost(stage_of[l]) * len(nt.UNIT_KEYS)
               for l in range(cfg.n_layers))


def _layer_idx(path) -> int:
    """The layer index of a ``("layers", i, key)`` grads-tree path."""
    return path[1]


def _bucket_syncers(staged: nu.StagedPlan, stage_plans, mode):
    """(issue, complete) closures. ``issue`` packs a bucket's unit-leaf
    grads (each (D, n1*buf, *unit)) into one (D*n1*buf, ΣE) flat with one
    `bucket_pack` launch and — on a degraded stage — runs the pre-sync
    reshard; ``complete`` sums over replicas (psum('data')), runs the
    post-sync reshard when degraded, and unpacks with one `bucket_unpack`
    launch."""

    def issue(bucket: Bucket, arrs):
        shapes = tuple(a.shape for a in arrs)
        d_axis, slots = shapes[0][:2]
        flats = [a.reshape(d_axis * slots, -1) for a in arrs]
        widths = tuple(f.shape[1] for f in flats)
        flat = bucket_pack(flats)
        degraded = mode is nt.Mode.NTP and not staged.stages[bucket.stage].healthy
        if degraded:
            wp = stage_plans[bucket.stage][bucket.kind]
            flat = rs.reshard(flat.reshape(d_axis, -1, wp.buf, sum(widths)),
                              wp.pre)
        return (bucket, flat, widths, shapes, degraded)

    def complete(state):
        bucket, flat, widths, shapes, degraded = state
        d_axis = shapes[0][0]
        if degraded:
            wp = stage_plans[bucket.stage][bucket.kind]
            summed = flat.sum(dim=0, keepdim=True).expand_as(flat)
            flat = rs.reshard(summed, wp.post)
        else:
            flat = flat.reshape(d_axis, -1, flat.shape[-1])
            flat = flat.sum(dim=0, keepdim=True).expand_as(flat)
        flat = flat.reshape(-1, sum(widths))
        parts = bucket_unpack(flat, widths)
        return [p.reshape(s) for p, s in zip(parts, shapes)]

    return issue, complete


def make_sync_grads(cfg, staged, *, mode, bucketed: bool = False,
                    mesh=None):
    """The gradient-sync body shared by the step builders: each layer's unit
    grads reshard → psum('data') → reshard under its own stage's plan; a
    healthy stage (or a non-NTP mode) takes the plain sum over replicas.
    Replicated leaves (the MoE router too) pass through: the one-graph
    backward already summed them.

    ``bucketed=False`` is the sequential per-leaf route; ``bucketed=True``
    fuses each (stage, plan-kind) group into one flat payload via the bucket
    kernels. The returned callable carries ``.collectives`` (static launch
    count) and ``.bucketed``.

    On a `launch.mesh.RankMesh` ``mesh`` the sync is this process's: per
    leaf (`_make_rank_sync`) or bucketed (`_make_rank_bucketed_sync`), each
    layer under its own stage's plan (on a staged mesh over the process's
    own stage only); it also carries ``.replicated_collectives``, the
    all-reduces of the replicated leaves, counted apart."""
    if mesh is not None:
        if bucketed:
            return _make_rank_bucketed_sync(cfg, staged, mode, mesh)
        return _make_rank_sync(cfg, staged, mode, mesh)
    staged = nu.as_staged(staged)
    mode = nt.Mode.coerce(mode)
    stage_of = layer_stages(cfg.n_layers, staged.pp)
    stage_plans = [nt._plans(cfg, p) for p in staged.stages]
    degraded = [mode is nt.Mode.NTP and not p.healthy for p in staged.stages]

    if not bucketed:
        def sync(path, g):
            s = stage_of[_layer_idx(path)]
            if not degraded[s]:
                return rs.uniform_sync_gradient(g, out=g)
            key = tr.leaf_key(path)
            wp = stage_plans[s]["attn" if key in _ATTN_KEYS else "mlp"]
            g4 = g.reshape(g.shape[0], -1, wp.buf, g[0, 0].numel())
            return rs.ntp_sync_gradient(g4, wp, out=g4).reshape(g.shape)

        @torch.no_grad()
        def sync_grads(grads):
            """Syncs each unit leaf of ``grads`` in place (a pre-sync value
            is dead once summed), as the rank syncs do: the sync holds one
            leaf's temporaries, not a second gradient tree. It consumes
            ``grads``."""
            for path, g in tr.leaves_with_path(grads):
                if tr.leaf_key(path) in nt.UNIT_KEYS:
                    tr.set_path(grads, path, sync(path, g))
            return grads

        sync_grads.collectives = sync_collectives(cfg, staged, mode,
                                                  bucketed=False)
        sync_grads.bucketed = False
        return sync_grads

    buckets = bucket_layout(cfg, staged)
    issue, complete = _bucket_syncers(staged, stage_plans, mode)

    @torch.no_grad()
    def sync_grads(grads):
        layers = [dict(lp) for lp in grads["layers"]]
        # issue every bucket, then complete: a standalone sync has no
        # backward to hide behind
        states = [issue(b, [layers[l][k] for l, k in b.leaves])
                  for b in buckets]
        for b, st in zip(buckets, states):
            for (l, k), g in zip(b.leaves, complete(st)):
                layers[l][k] = g
        return dict(grads, layers=layers)

    sync_grads.collectives = sync_collectives(cfg, staged, mode,
                                              bucketed=True)
    sync_grads.bucketed = True
    return sync_grads


def _rank_layout(cfg, plan, mode, mesh):
    """(staged plan, mode, stage of each layer, {stage: {kind: WeightPlan}},
    degraded per stage, this process's layer ids, its top-level keys) of a
    rank sync: on a staged mesh the process holds one stage's share."""
    staged = nu.as_staged(plan)
    mode = nt.Mode.coerce(mode)
    stage_plans = [nt._plans(cfg, p) for p in staged.stages]
    degraded = [mode is nt.Mode.NTP and not p.healthy for p in staged.stages]
    own, top = nt.stage_share(cfg, staged.pp, nt._rank_stage(mesh))
    return (staged, mode, layer_stages(cfg.n_layers, staged.pp), stage_plans,
            degraded, own, top)


def _make_rank_sync(cfg, plan, mode, mesh):
    """The sequential per-leaf sync of one (replica, rank) process, in
    flatten order on every rank (a collective order every rank shares):
    each unit leaf's gradient (buf, *unit) reshards → sums over data →
    reshards (`core.reshard.ntp_sync_gradient_rank`) under its layer's
    stage plan when that is degraded under NTP, and sums over data
    otherwise — ``.collectives`` of them over the whole mesh, as
    `sync_collectives(bucketed=False)` counts; then each replicated leaf
    (held whole by every rank, its replica's share) sums over data, an MoE
    router first over model (`_sum_router_`): ``.replicated_collectives``
    more all-reduces on this process. On a
    staged mesh a process syncs its stage's leaves only, over that stage's
    groups. Gradients are synced in place where the route allows."""
    staged, mode, stage_of, stage_plans, degraded, own, top = _rank_layout(
        cfg, plan, mode, mesh)

    def sync_unit(path, g):
        s = stage_of[_layer_idx(path)]
        if not degraded[s]:
            return rs.uniform_sync_gradient_rank(g, mesh)
        key = tr.leaf_key(path)
        wp = stage_plans[s]["attn" if key in _ATTN_KEYS else "mlp"]
        return rs.ntp_sync_gradient_rank(g.reshape(wp.buf, -1), wp,
                                         mesh).reshape(g.shape)

    @torch.no_grad()
    def sync_grads(grads):
        out = tr.tree_map(lambda g: g, grads)
        leaves = list(tr.leaves_with_path(grads))
        for path, g in leaves:
            if tr.leaf_key(path) in nt.UNIT_KEYS:
                tr.set_path(out, path, sync_unit(path, g))
        for path, g in leaves:
            key = tr.leaf_key(path)
            if key not in nt.UNIT_KEYS:
                if key == "router":
                    g = _sum_router_(g, mesh)
                tr.set_path(out, path,
                            rs.uniform_sync_gradient_rank(g, mesh))
        return out

    sync_grads.collectives = sync_collectives(cfg, staged, mode,
                                              bucketed=False)
    sync_grads.replicated_collectives = len(top) + \
        (4 if cfg.is_moe else 2) * len(own)
    sync_grads.bucketed = False
    return sync_grads


_TOP_KEYS = ("final_norm", "head", "embed")


def _sum_router_(g: torch.Tensor, mesh) -> torch.Tensor:
    """In-place sum of one rank's router gradient over the model group:
    each rank's holds the gates of its own experts only."""
    return C.psum_(g.contiguous(), mesh.model)


def _rank_chunk_syncers(cfg, plan, mode, mesh, chunks):
    """(issue, complete) of one rank's chunk syncs. ``issue(ci, layers)``
    takes chunk ``ci``'s layer grads (``layers[l][key]``) and, for each of
    its unit buckets (attn, mlp), packs the leaves ``(buf, *unit)`` into one
    ``(buf, ΣE)`` flat (one `bucket_pack` launch), runs the pre-sync
    `reshard_rank` when the chunk's stage plan is degraded under NTP and
    starts the sum over ``data``; then the same for its rep bucket
    (``ln1``/``ln2`` and an MoE layer's ``router`` as rows-1 flats, summed
    only; each router summed over ``model`` first). ``complete(state)``
    waits on each sum, runs the post-sync reshard when degraded, unpacks
    (one `bucket_unpack` launch a bucket) and returns ``[((layer, key),
    grad), ...]``. Every rank issues the same collectives in the same
    order. A chunk never straddles two stages (`chunk_ranges`)."""
    _, mode, stage_of, stage_plans, degraded, _, _ = _rank_layout(
        cfg, plan, mode, mesh)
    buckets = [
        tuple(Bucket(stage_of[lo], kind,
                     tuple((l, k) for l in range(lo, hi) for k in keys))
              for kind, keys in (("attn", _ATTN_KEYS), ("mlp", _MLP_KEYS)))
        for lo, hi in chunks
    ]

    def pack(arrs, rows):
        shapes = tuple(a.shape for a in arrs)
        flats = [a.reshape(rows or a.shape[0], -1).contiguous() for a in arrs]
        return bucket_pack(flats), tuple(f.shape[1] for f in flats), shapes

    def unpack(flat, widths, shapes):
        return [p.reshape(s) for p, s in zip(bucket_unpack(flat, widths),
                                             shapes)]

    @torch.no_grad()
    def issue(ci, layers):
        """Takes (pops) chunk ``ci``'s grads out of ``layers``: each leaf is
        freed once its bucket is packed."""
        lo, hi = chunks[ci]
        units = []
        for b in buckets[ci]:
            flat, widths, shapes = pack([layers[l].pop(k)
                                         for l, k in b.leaves], None)
            if degraded[b.stage]:
                flat = rs.reshard_rank(flat, stage_plans[b.stage][b.kind].pre,
                                       mesh)
            units.append((b, C.psum_async_(flat, mesh.data), widths, shapes))
        rep_keys = [(l, k) for l in range(lo, hi) for k in nt.REP_KEYS
                    if k in layers[l]]
        flat, widths, shapes = pack(
            [_sum_router_(layers[l].pop(k), mesh) if k == "router"
             else layers[l].pop(k) for l, k in rep_keys], 1)
        return units, (rep_keys, C.psum_async_(flat, mesh.data), widths,
                       shapes)

    @torch.no_grad()
    def complete(state):
        units, (rep_keys, rep, rep_widths, rep_shapes) = state
        out = []
        for b, pending, widths, shapes in units:
            flat = pending.wait()
            if degraded[b.stage]:
                flat = rs.reshard_rank(flat, stage_plans[b.stage][b.kind].post,
                                       mesh)
            out.extend(zip(b.leaves, unpack(flat, widths, shapes)))
        out.extend(zip(rep_keys, unpack(rep.wait(), rep_widths, rep_shapes)))
        return out

    return issue, complete


def _router_sums(cfg, chunks) -> int:
    """The routers' sums over ``model`` of one rank's bucketed sync (one a
    MoE layer of ``chunks``)."""
    return sum(hi - lo for lo, hi in chunks) if cfg.is_moe else 0


def _rank_chunks(cfg, plan, mesh):
    """(this process's chunks, the whole mesh's): `chunk_ranges` of the
    plan's stages (the stages at pp>1); on a staged mesh the process takes
    its own stage's chunk only."""
    staged = nu.as_staged(plan)
    every = chunk_ranges(cfg.n_layers, staged.pp)
    stage = nt._rank_stage(mesh)
    if stage is None:
        return every, every
    stage_of = layer_stages(cfg.n_layers, staged.pp)
    return tuple(c for c in every if stage_of[c[0]] == stage), every


def _make_rank_bucketed_sync(cfg, plan, mode, mesh):
    """The standalone bucketed sync of one (replica, rank) process, the
    rank twin of ``make_sync_grads(bucketed=True)`` on the overlapped
    step's buckets (`chunk_ranges`; one chunk of every layer would stage
    GBs a bucket): each chunk's two unit buckets and its rep bucket issued
    in the step's order, a chunk completed once the next is issued, then
    ``final_norm``, ``head`` and ``embed`` (those the process holds) summed
    over data in place, one after another. It consumes ``grads`` (each
    layer leaf is freed once packed; the layer dicts come back holding the
    synced leaves), as the per-leaf rank sync sums in place. On a staged
    mesh the process syncs its stage's chunk: one fused collective per
    (stage, plan-kind), as the reference's submesh step. ``.collectives``
    counts the whole mesh's unit buckets as `sync_collectives(bucketed=True,
    chunks=)` does; ``.replicated_collectives`` this process's rep buckets
    and in-place sums."""
    staged = nu.as_staged(plan)
    mode = nt.Mode.coerce(mode)
    chunks, every = _rank_chunks(cfg, staged, mesh)
    issue, complete = _rank_chunk_syncers(cfg, staged, mode, mesh, chunks)
    _, top = nt.stage_share(cfg, staged.pp, nt._rank_stage(mesh))

    @torch.no_grad()
    def sync_grads(grads):
        layers = grads["layers"]
        done, pending = [], None
        for ci in reversed(range(len(chunks))):
            state = issue(ci, layers)
            if pending is not None:
                done += complete(pending)
            pending = state
        done += complete(pending)
        for (l, k), g in done:
            layers[l][k] = g
        return dict({k: C.psum_(grads[k].contiguous(), mesh.data)
                     for k in _TOP_KEYS if k in top}, layers=layers)

    sync_grads.collectives = sync_collectives(cfg, staged, mode, bucketed=True,
                                              chunks=every)
    sync_grads.replicated_collectives = len(chunks) + len(top) + \
        _router_sums(cfg, chunks)
    sync_grads.bucketed = True
    return sync_grads


class _SideStream:
    """Runs the sync on a second CUDA stream beside the backward; on the CPU
    everything runs in order on the host and this does nothing."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.main = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)

    def run(self, fn, inputs):
        """``fn()`` on the side stream, after the main stream's work so far
        (which produced ``inputs``); ``inputs`` stay allocated until the side
        stream is done with them."""
        if not self.cuda:
            return fn()
        self.side.wait_stream(self.main)
        for t in inputs:
            t.record_stream(self.side)
        t = inputs = None   # what ``fn`` frees is freed
        with torch.cuda.stream(self.side):
            return fn()

    def join(self, outputs):
        """Make the main stream wait for the side stream; ``outputs`` (made
        on the side stream) stay allocated until the main stream is done."""
        if not self.cuda:
            return
        self.main.wait_stream(self.side)
        for t in outputs:
            t.record_stream(self.main)


def make_overlapped_train_step(
    cfg,
    fplan,
    *,
    mode=nt.Mode.NTP,
    local_batch: int = 4,
    optimizer: Optional[Optimizer] = None,
    local_batches=None,
    microbatches: int = 1,
):
    """Overlapped twin of `ntp_train.make_ntp_train_step`: same contract
    (``step(params, opt_state, batch) -> (params, opt_state, metrics)``),
    same loss, gradients equal to the sequential step's up to the order of
    f32 sums — but the backward is layer-chunked with each chunk's bucket
    sync issued while the next (earlier) chunk's backward runs.

    ``fplan`` is a `FailurePlan` or a `StagedPlan` (each chunk is then one
    stage and syncs under that stage's plan). ``microbatches`` is validated
    exactly as the staged builder's, but the forward runs the full local
    batch in ONE chunked pass, as the reference's overlapped step does: the
    sample mask does not depend on the microbatching, so the loss equals
    the microbatched one up to the order of f32 sums.

    The returned step carries probes: ``.overlap`` (True), ``.chunks``,
    ``.collectives`` (static unit-bucket launch count), ``.grads_fn``
    (loss + synced grads) and ``.sync_fn`` / ``.sync_off_fn`` (standalone
    bucketed / sequential sync of a grads tree)."""
    staged = nu.as_staged(fplan)
    mode = nt.Mode.coerce(mode)
    optimizer = optimizer or sgd(1e-2)
    d_axis, n1 = staged.d, staged.n1
    nt.validate_microbatches(microbatches, local_batch)
    stage_of = layer_stages(cfg.n_layers, staged.pp)
    stage_plans = [nt._plans(cfg, p) for p in staged.stages]
    lb = nt._validated_local_batches(local_batches, staged.effective, mode,
                                     local_batch, d_axis)
    sample_mask = nt._sample_masks(lb)

    chunks = chunk_ranges(cfg.n_layers, staged.pp)
    per_chunk_buckets = [
        tuple(Bucket(stage_of[lo], kind,
                     tuple((l, k) for l in range(lo, hi) for k in keys))
              for kind, keys in (("attn", _ATTN_KEYS), ("mlp", _MLP_KEYS)))
        for lo, hi in chunks
    ]
    issue, complete = _bucket_syncers(staged, stage_plans, mode)

    def loss_and_grads(params, batch):
        dev = params["embed"].device
        tokens = nt._split_batch(batch, d_axis, dev)
        mask = sample_mask(tokens.shape[1], dev)
        inp, tgt = tokens[..., :-1], tokens[..., 1:]
        leaves = nt._grad_leaves(params)
        uids = nt.moe_slots(cfg, staged, dev)

        # ---- forward: embed | chunk_0 … chunk_{C-1} | tail, each chunk on
        # a detached input so its backward can run on its own
        x0 = leaves["embed"][inp]
        x = x0
        chunk_io = []
        for lo, hi in chunks:
            xin = x.detach().requires_grad_(True)
            xx = xin
            for l in range(lo, hi):
                xx = nt._layer(leaves["layers"][l], xx, cfg, n1,
                               None if uids is None else uids[l])
            chunk_io.append((xin, xx))
            x = xx
        x_tail = x.detach().requires_grad_(True)
        loss = nt._global_loss(*nt._tail_totals(
            leaves["final_norm"], leaves["head"], x_tail, tgt, mask))

        # ---- backward with a one-chunk-deep in-flight sync pipeline
        g_fn, g_head, dx = torch.autograd.grad(
            loss, [leaves["final_norm"], leaves["head"], x_tail])
        stream = _SideStream(dev)
        g_layers = [None] * cfg.n_layers
        synced = []
        pending = None
        for ci in reversed(range(len(chunks))):
            lo, hi = chunks[ci]
            xin, xout = chunk_io[ci]
            keys = [(l, k) for l in range(lo, hi)
                    for k in sorted(leaves["layers"][l])]
            grads = torch.autograd.grad(
                xout, [leaves["layers"][l][k] for l, k in keys] + [xin],
                grad_outputs=dx)
            dx = grads[-1]
            for (l, k), g in zip(keys, grads):
                if g_layers[l] is None:
                    g_layers[l] = {}
                g_layers[l][k] = g
            if pending is not None:
                synced.append(stream.run(lambda p=pending: _finish(p), ()))
            unit = [g_layers[l][k] for b in per_chunk_buckets[ci]
                    for l, k in b.leaves]
            pending = stream.run(
                lambda ci=ci: [(b, issue(b, [g_layers[l][k]
                                             for l, k in b.leaves]))
                               for b in per_chunk_buckets[ci]],
                unit)
        synced.append(stream.run(lambda p=pending: _finish(p), ()))
        (g_embed,) = torch.autograd.grad(x0, [leaves["embed"]],
                                         grad_outputs=dx)
        outs = []
        for done in synced:
            for (l, k), g in done:
                g_layers[l][k] = g
                outs.append(g)
        stream.join(outs)
        grads = {"embed": g_embed, "head": g_head, "final_norm": g_fn,
                 "layers": g_layers}
        return loss.detach(), grads

    def _finish(pending):
        out = []
        for b, st in pending:
            out.extend(zip(b.leaves, complete(st)))
        return out

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, metrics = optimizer.update(
            grads, opt_state, params,
            norm_weights=nt._norm_weights(grads, d_axis))
        return params, opt_state, dict(metrics, loss=loss)

    step.overlap = True
    step.chunks = chunks
    step.collectives = sync_collectives(cfg, staged, mode, bucketed=True,
                                        chunks=chunks)
    step.grads_fn = loss_and_grads
    step.sync_fn = make_sync_grads(cfg, staged, mode=mode, bucketed=True)
    step.sync_off_fn = make_sync_grads(cfg, staged, mode=mode,
                                       bucketed=False)
    return step


def make_overlapped_rank_train_step(
    cfg,
    fplan,
    mesh,
    *,
    mode=nt.Mode.NTP,
    local_batch: int = 4,
    optimizer: Optional[Optimizer] = None,
    local_batches=None,
    microbatches: int = 1,
):
    """Overlapped twin of `ntp_train.make_rank_train_step` on one (replica,
    rank) process of a 2-D mesh, the per-rank form of the reference's
    `make_overlapped_train_step`: same contract and probes as the
    emulated overlapped step, ``loss`` and ``grad_norm`` the global ones,
    equal on every rank, and values equal to the sequential rank step's up
    to the order of f32 sums. Under a `StagedPlan` (the stage-sequential
    route) the chunks are the stages and each syncs under its own stage's
    plan; ``microbatches`` is validated, and the forward runs the whole
    local batch in one chunked pass, as the emulated overlapped step does.

    The forward runs chunk by chunk on `chunk_ranges` (each chunk on a
    detached, grad-requiring input, its layers between the Megatron pair);
    the backward runs chunk by chunk with `torch.autograd.grad`. The tail's
    ``final_norm``/``head`` grads start their sums over data first; each
    chunk's buckets are issued as soon as its grads exist and completed
    after the next (earlier) chunk's backward has been issued; ``embed`` is
    summed last, once ``head``'s sum has landed. The sync runs on a second
    CUDA stream (`_SideStream`); every in-flight flat stays referenced by
    its handle until waited on."""
    plan = fplan.stages[0] if isinstance(fplan, nu.StagedPlan) and \
        fplan.pp == 1 else fplan
    if (plan.d, plan.n1) != tuple(mesh) or nt._rank_stage(mesh) is not None:
        raise ValueError(f"plan {plan} does not fit the 2-D mesh "
                         f"{tuple(mesh)}")
    mode = nt.Mode.coerce(mode)
    optimizer = optimizer or sgd(1e-2)
    nt.validate_microbatches(microbatches, local_batch)
    masks = nt._sample_masks(nt._validated_local_batches(
        local_batches, plan, mode, local_batch, plan.d))
    chunks, _ = _rank_chunks(cfg, plan, mesh)
    issue, complete = _rank_chunk_syncers(cfg, plan, mode, mesh, chunks)

    def loss_and_grads(params, batch):
        dev = params["embed"].device
        tokens, mask = nt._rank_tokens(batch, mesh, masks, dev)
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        leaves = nt._grad_leaves(params)
        uids = nt.rank_moe_slots(cfg, plan, mesh, dev)

        # ---- forward: embed | chunk_0 … chunk_{C-1} | tail
        x0 = leaves["embed"][inp]
        x = x0
        chunk_io = []
        for lo, hi in chunks:
            xin = x.detach().requires_grad_(True)
            xx = xin
            for l in range(lo, hi):
                xx = nt._rank_layer(leaves["layers"][l], xx, cfg, mesh.model,
                                    None if uids is None else uids[l])
            chunk_io.append((xin, xx))
            x = xx
        x_tail = x.detach().requires_grad_(True)
        total, count = nt._rank_tail(leaves["final_norm"], leaves["head"],
                                     x_tail, tgt, mask)
        tc = C.psum(torch.stack([total.detach(), count]), mesh.data)
        denom = torch.clamp(tc[1], min=1.0)

        # ---- backward with a one-chunk-deep in-flight sync pipeline
        g_fn, g_head, dx = torch.autograd.grad(
            total / denom, [leaves["final_norm"], leaves["head"], x_tail])
        stream = _SideStream(dev)
        tail = stream.run(lambda: [C.psum_async_(g.contiguous(), mesh.data)
                                   for g in (g_fn, g_head)], (g_fn, g_head))
        del g_fn, g_head
        g_layers = [dict() for _ in range(cfg.n_layers)]
        synced = []
        pending = None
        for ci in reversed(range(len(chunks))):
            lo, hi = chunks[ci]
            xin, xout = chunk_io[ci]
            keys = [(l, k) for l in range(lo, hi)
                    for k in sorted(leaves["layers"][l])]
            grads = torch.autograd.grad(
                xout, [leaves["layers"][l][k] for l, k in keys] + [xin],
                grad_outputs=dx)
            dx = grads[-1]
            for (l, k), g in zip(keys, grads):
                g_layers[l][k] = g
            del grads
            if pending is not None:
                synced.append(stream.run(lambda p=pending: complete(p), ()))
            pending = stream.run(
                lambda ci=ci: issue(ci, g_layers),
                [g_layers[l][k] for l, k in keys])
        synced.append(stream.run(lambda p=pending: complete(p), ()))
        del pending
        (g_embed,) = torch.autograd.grad(x0, [leaves["embed"]],
                                         grad_outputs=dx)
        # head's sum lands before embed's starts: gloo stages a CUDA
        # tensor through pinned host memory, and one GB-sized staging
        # buffer a rank is enough
        g_fn, g_head = stream.run(lambda: [p.wait() for p in tail], ())
        g_embed = stream.run(
            lambda: C.psum_(g_embed.contiguous(), mesh.data), (g_embed,))
        outs = [g_embed, g_fn, g_head]
        for done in synced:
            for (l, k), g in done:
                g_layers[l][k] = g
                outs.append(g)
        stream.join(outs)
        grads = {"embed": g_embed, "head": g_head, "final_norm": g_fn,
                 "layers": g_layers}
        return tc[0] / denom, grads

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, metrics = optimizer.update(
            grads, opt_state, params, grad_norm=nt.rank_grad_norm(grads, mesh))
        return params, opt_state, dict(metrics, loss=loss)

    step.overlap = True
    step.chunks = chunks
    step.collectives = sync_collectives(cfg, plan, mode, bucketed=True,
                                        chunks=chunks)
    step.replicated_collectives = len(chunks) + len(_TOP_KEYS) + \
        _router_sums(cfg, chunks)
    step.grads_fn = loss_and_grads
    step.sync_fn = make_sync_grads(cfg, plan, mode=mode, bucketed=True,
                                   mesh=mesh)
    step.sync_off_fn = make_sync_grads(cfg, plan, mode=mode, mesh=mesh)
    return step
