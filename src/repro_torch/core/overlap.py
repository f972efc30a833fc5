"""Overlapped, bucketed gradient synchronization (port of
`repro/core/overlap.py` at pp=1).

* `make_sync_grads` is the one sync body of the step builders. With
  ``bucketed=False`` it is the per-leaf reshard → psum('data') → reshard
  route; with ``bucketed=True`` every unit leaf sharing a WeightPlan is fused
  into one flat ``(rows, ΣE)`` buffer by the hand-written `bucket_pack`
  kernel before the sync and split by `bucket_unpack` after it. The rows are
  every emulated (replica, rank, slot) buffer row, so one launch packs a
  whole bucket. The fused buffer reshards under the per-leaf Algorithm-1
  tables unchanged (they index unit rows only), so bucketed and sequential
  syncs agree exactly.

* `make_overlapped_train_step` chunks the backward on the
  `stage_boundaries` ladder (at most `DEFAULT_CHUNKS` chunks): each chunk
  runs forward on a detached, grad-requiring input, and the backward runs
  chunk by chunk with `torch.autograd.grad`. Each chunk's bucket sync is
  ISSUED (pack + pre-sync reshard) on a second CUDA stream as soon as its
  grads exist and COMPLETED (sum over replicas + post-sync reshard +
  unpack) after the next chunk's backward has been issued — the reference's
  issue-L / complete-L+1 order, so the sync's kernels can run beside the
  backward's. Cross-stream use is made safe with `wait_stream` (the side
  stream waits for the grads it reads; the main stream waits for the synced
  grads before the optimizer) and `record_stream` (so the caching allocator
  does not hand a block to another stream while a kernel still reads it).

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


def _require_pp1(staged) -> nu.StagedPlan:
    staged = nu.as_staged(staged)
    if staged.pp != 1:
        raise NotImplementedError(
            "pipeline-parallel NTP training (pp>1) is not ported yet: "
            "ROADMAP Queue 1, 'pp>1 in the port'")
    return staged


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


def make_sync_grads(cfg, staged, *, mode, bucketed: bool = False):
    """The gradient-sync body shared by the step builders: each layer's unit
    grads reshard → psum('data') → reshard under the plan; a healthy plan
    (or a non-NTP mode) takes the plain sum over replicas. Replicated leaves
    pass through: the one-graph backward already summed them.

    ``bucketed=False`` is the sequential per-leaf route; ``bucketed=True``
    fuses each plan-kind group into one flat payload via the bucket kernels.
    The returned callable carries ``.collectives`` (static launch count) and
    ``.bucketed``."""
    staged = _require_pp1(staged)
    mode = nt.Mode.coerce(mode)
    plan = staged.stages[0]
    stage_plans = [nt._plans(cfg, plan)]
    degraded = mode is nt.Mode.NTP and not plan.healthy

    if not bucketed:
        @torch.no_grad()
        def sync_grads(grads):
            def sync(path, g):
                key = tr.leaf_key(path)
                if key not in nt.UNIT_KEYS:
                    return g
                if not degraded:
                    return rs.uniform_sync_gradient(g)
                wp = stage_plans[0]["attn" if key in _ATTN_KEYS else "mlp"]
                g4 = g.reshape(g.shape[0], -1, wp.buf,
                               g[0, 0].numel())
                return rs.ntp_sync_gradient(g4, wp).reshape(g.shape)

            return tr.tree_map_with_path(sync, grads)

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
):
    """Overlapped twin of `ntp_train.make_ntp_train_step`: same contract
    (``step(params, opt_state, batch) -> (params, opt_state, metrics)``),
    same loss, gradients equal to the sequential step's up to the order of
    f32 sums — but the backward is layer-chunked with each chunk's bucket
    sync issued while the next (earlier) chunk's backward runs.

    The returned step carries probes: ``.overlap`` (True), ``.chunks``,
    ``.collectives`` (static unit-bucket launch count), ``.grads_fn``
    (loss + synced grads) and ``.sync_fn`` / ``.sync_off_fn`` (standalone
    bucketed / sequential sync of a grads tree)."""
    staged = _require_pp1(fplan)
    plan = staged.stages[0]
    mode = nt.Mode.coerce(mode)
    optimizer = optimizer or sgd(1e-2)
    d_axis, n1 = plan.d, plan.n1
    stage_plans = [nt._plans(cfg, plan)]
    lb = nt._validated_local_batches(local_batches, plan, mode, local_batch,
                                     d_axis)
    sample_mask = nt._sample_masks(lb)

    chunks = chunk_ranges(cfg.n_layers, 1)
    per_chunk_buckets = [
        tuple(Bucket(0, kind, tuple((l, k) for l in range(lo, hi)
                                    for k in keys))
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

        # ---- forward: embed | chunk_0 … chunk_{C-1} | tail, each chunk on
        # a detached input so its backward can run on its own
        x0 = leaves["embed"][inp]
        x = x0
        chunk_io = []
        for lo, hi in chunks:
            xin = x.detach().requires_grad_(True)
            xx = xin
            for l in range(lo, hi):
                xx = nt._layer(leaves["layers"][l], xx, cfg, n1)
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
