"""Collectives of the process path (the port's counterpart of the
`jax.lax` collectives the reference calls inside shard_map).

* `psum` / `psum_` — ``jax.lax.psum`` over a group: `all_reduce` (sum);
  `psum_async_` issues it and returns a handle (the overlapped sync's);
  `pmax_` the maximum (the vocab-parallel loss's).
* the Megatron pair, for per-rank autograd: `copy_to_model` is the identity
  forward and an all-reduce over the model group backward (at a block's
  input); `reduce_from_model` is an all-reduce forward and the identity
  backward (at a block's output). With the pair each rank's backward sees
  the full gradient of the replicated activations exactly once. The
  reference reaches the same result by seeding ``ct/n1`` on each model rank
  (`repro/core/overlap.py:36-45, :424`); an all-reduce whose backward is
  also an all-reduce counts the gradient n1 times.
* the expert-parallel MoE's and split heads' autograd collectives:
  `all_to_all` (its backward the reverse all-to-all, the split sizes
  swapped); `gather_from_model` (an all-gather over ``model`` whose
  backward keeps this rank's slice: the cotangent of a replicated
  activation is whole on every rank, as the Megatron pair leaves it);
  `gather_into_region` (an all-gather whose result feeds rank-local,
  partial work, so its backward sums the ranks' cotangents and keeps this
  rank's slice: a reduce-scatter, `reduce_scatter_units`); `mesh_mean`
  (the routing statistics averaged over every process, see its
  docstring for the adjoint).
* `all_to_all_units` — ``jax.lax.all_to_all`` with per-peer split sizes
  (`all_to_all_single`), the reshard's and the transitions' message route.
* `all_gather_units` — the canonical gather of a replica's unit buffers.
* `reduce_scatter_units` — ``jax.lax.psum_scatter``: the peers' tensors
  summed, this peer's slice kept (one all-to-all of the slices, summed).
* `StageLink` — the pipeline hand-off of a staged mesh, ``jax.lax.ppermute``
  over ``stage`` and its transpose: `send_next` / `recv_prev` carry a
  boundary activation to the same (replica, rank) of the next stage,
  `send_prev` / `recv_next` its cotangent back.

Every call adds one to its (op, group) counter and its payload bytes to the
same counter (`counts`, `reset_counts`): an all-reduce's tensor, an
all-to-all's send buffer (the part to itself included), an all-gather's
input, a reduce-scatter's input. A group is named by its ``group_desc``
(``"model"`` / ``"data"`` for `launch.mesh.make_test_mesh`'s groups).

Every collective takes the tensors where they lie: gloo takes CUDA tensors
for `all_reduce`, `all_to_all_single` with uneven splits and `all_gather`
(probed on an H100 with torch 2.11, `chip_smoke.py` phase 10 checks it each
run), so nothing is staged through host buffers there. Gloo's point-to-point
`send` / `recv` take CPU tensors only, so on gloo `StageLink` stages a CUDA
activation through a pinned host buffer it keeps per shape and reuses
(chosen by the mesh's backend name; NCCL sends device tensors as they are).
The hand-off's ops are counted under ``(op, "stage")``: ``send_next`` /
``recv_prev`` forward, ``send_prev`` / ``recv_next`` backward.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

_counts: Dict[Tuple[str, str], list] = {}


def group_name(group) -> str:
    return getattr(group, "group_desc", None) or "default"


def _count(op: str, group, nbytes: int) -> None:
    c = _counts.setdefault((op, group_name(group)), [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def counts() -> Dict[Tuple[str, str], Tuple[int, int]]:
    """(calls, bytes) per (op, group) since the last `reset_counts`."""
    return {k: (v[0], v[1]) for k, v in _counts.items()}


def reset_counts() -> None:
    _counts.clear()


def psum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``x`` over ``group`` (a contiguous tensor); returns
    ``x``."""
    _count("all_reduce", group, x.numel() * x.element_size())
    dist.all_reduce(x, group=group)
    return x


class Pending:
    """An in-flight `psum_async_`: ``wait()`` blocks until the sum has
    landed in the tensor (on CUDA: until the current stream may read it)
    and returns the tensor. The handle keeps the tensor alive until then,
    and drops the backend's work (with whatever it staged, e.g. gloo's
    pinned host copy of a CUDA tensor) once waited on."""

    __slots__ = ("_work", "_x")

    def __init__(self, work, x: torch.Tensor):
        self._work, self._x = work, x

    def wait(self) -> torch.Tensor:
        self._work.wait()
        self._work = None
        return self._x


def psum_async_(x: torch.Tensor, group) -> Pending:
    """`psum_` issued without waiting (``async_op=True``), counted when it is
    issued: ``x`` (contiguous) must not be read or written before the
    handle's ``wait()``, which returns it summed over ``group``."""
    _count("all_reduce", group, x.numel() * x.element_size())
    return Pending(dist.all_reduce(x, group=group, async_op=True), x)


def pmax_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place maximum of ``x`` over ``group`` (``jax.lax.pmax``; a
    contiguous tensor), counted as ``all_reduce_max``; returns ``x``."""
    _count("all_reduce_max", group, x.numel() * x.element_size())
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``: a fresh tensor, ``x`` summed over
    ``group``."""
    return psum_(x.contiguous().clone(), group)


def all_to_all_units(send: torch.Tensor, send_counts: Sequence[int],
                     recv_counts: Sequence[int], group) -> torch.Tensor:
    """Rows ``send[sum(send_counts[:j]) : ...]`` go to peer j of ``group``;
    returns the rows received, peer by peer (``recv_counts[j]`` from peer
    j). Zero counts are legal; every peer must call with matching counts."""
    send = send.contiguous()
    out = send.new_empty((sum(recv_counts),) + tuple(send.shape[1:]))
    _count("all_to_all", group, send.numel() * send.element_size())
    dist.all_to_all_single(out, send, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts), group=group)
    return out


def all_gather_units(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every peer's ``x``, in group-rank order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    _count("all_gather", group, x.numel() * x.element_size())
    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def reduce_scatter_units(x: torch.Tensor, group, dim: int = 0
                         ) -> torch.Tensor:
    """``x`` summed over ``group`` and cut into ``n`` equal slices along
    ``dim``, this peer's slice kept (``jax.lax.psum_scatter(..., tiled=
    True)``). Carried by one all-to-all of the slices (gloo has it for
    CUDA tensors), counted as ``reduce_scatter``."""
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=dim)).contiguous()   # (n, ...)
    _count("reduce_scatter", group, parts.numel() * parts.element_size())
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return out.sum(0)


def broadcast_stage_(x: torch.Tensor, src_stage: int, mesh) -> torch.Tensor:
    """In-place broadcast of ``x`` (contiguous) from this (replica, rank)'s
    process of stage ``src_stage`` to its processes of every stage (the
    ``stage`` group of a staged mesh); returns ``x``."""
    _count("broadcast", mesh.pipe, x.numel() * x.element_size())
    dist.broadcast(x, mesh.stage_peer(src_stage), group=mesh.pipe)
    return x


class StageLink:
    """The point-to-point hand-off of one process of a staged mesh
    (`launch.mesh.make_staged_mesh`): its peers are the same (replica,
    rank) of stages ``stage - 1`` and ``stage + 1``. Sends and receives
    block, and every pair of peers issues them in the same order, so the
    schedule (`core.pp_submesh`) alone orders them. On gloo a CUDA tensor
    goes through a pinned host buffer of its shape, made once and reused
    by every later call of the same shape and direction."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._host = mesh.backend == "gloo"
        self._buffers: Dict[tuple, torch.Tensor] = {}

    def _staging(self, x: torch.Tensor, way: str) -> torch.Tensor:
        key = (way, tuple(x.shape), x.dtype)
        if key not in self._buffers:
            self._buffers[key] = torch.empty(x.shape, dtype=x.dtype,
                                             pin_memory=True)
        return self._buffers[key]

    def _send(self, x: torch.Tensor, stage: int, op: str) -> None:
        x = x.detach().contiguous()
        _count(op, self._mesh.pipe, x.numel() * x.element_size())
        if self._host and x.is_cuda:
            x = self._staging(x, op).copy_(x)
        dist.send(x, self._mesh.stage_peer(stage))

    def _recv(self, like: torch.Tensor, stage: int, op: str) -> torch.Tensor:
        _count(op, self._mesh.pipe, like.numel() * like.element_size())
        if self._host and like.is_cuda:
            buf = self._staging(like, op)
            dist.recv(buf, self._mesh.stage_peer(stage))
            return buf.to(like.device)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, self._mesh.stage_peer(stage))
        return out

    def send_next(self, y: torch.Tensor) -> None:
        """Hand ``y`` (a boundary activation) to the next stage."""
        self._send(y, self._mesh.stage + 1, "send_next")

    def recv_prev(self, like: torch.Tensor) -> torch.Tensor:
        """The previous stage's boundary activation, a fresh tensor of
        ``like``'s shape, dtype and device."""
        return self._recv(like, self._mesh.stage - 1, "recv_prev")

    def send_prev(self, dx: torch.Tensor) -> None:
        """Hand ``dx`` (the cotangent of this stage's input) back."""
        self._send(dx, self._mesh.stage - 1, "send_prev")

    def recv_next(self, like: torch.Tensor) -> torch.Tensor:
        """The next stage's cotangent of this stage's output."""
        return self._recv(like, self._mesh.stage + 1, "recv_next")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce over ``group`` backward: a tensor-
    parallel block's input."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` forward, identity backward: a tensor-
    parallel block's output (its ranks' partial sums)."""
    return _ReduceFromModel.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_counts, recv_counts, group):
        ctx.args = (send_counts, recv_counts, group)
        return all_to_all_units(x, send_counts, recv_counts, group)

    @staticmethod
    def backward(ctx, g):
        send_counts, recv_counts, group = ctx.args
        return (all_to_all_units(g, recv_counts, send_counts, group), None,
                None, None)


def all_to_all(x: torch.Tensor, send_counts: Sequence[int],
               recv_counts: Sequence[int], group) -> torch.Tensor:
    """`all_to_all_units` with a backward: the cotangent of the rows
    received goes back to the peers they came from (the reverse
    all-to-all, the split sizes swapped)."""
    return _AllToAll.apply(x, tuple(send_counts), tuple(recv_counts), group)


def _gathered(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = all_gather_units(x, group)                 # (n, *x.shape)
    return torch.cat(list(parts.unbind(0)), dim=dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, dim):
        ctx.args = (x.shape[dim], rank, dim)
        return _gathered(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        size, rank, dim = ctx.args
        return g.narrow(dim, rank * size, size), None, None, None


class _GatherIntoRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _gathered(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return reduce_scatter_units(g, group, dim), None, None


def gather_from_model(x: torch.Tensor, group, rank: int,
                      dim: int = 0) -> torch.Tensor:
    """The peers' ``x`` concatenated along ``dim`` in group order (an
    all-gather), for a result every rank then uses whole, as a replicated
    activation: its cotangent is the same, whole, on every rank, so the
    backward keeps this rank's (``rank``'s) slice and moves nothing."""
    return _GatherFromModel.apply(x, group, rank, dim)


def gather_into_region(x: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
    """The peers' ``x`` concatenated along ``dim`` (an all-gather), for a
    result each rank computes only its part of the output from (the
    output leaves through `reduce_from_model`): the ranks' cotangents are
    partial, so the backward sums them and keeps this rank's slice (a
    reduce-scatter)."""
    return _GatherIntoRegion.apply(x, group, dim)


class _MeshMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n_model = mesh.n_model
        y = psum(x, mesh.model)
        if mesh.n_data > 1:
            psum_(y, mesh.data)
        return y.div_(mesh.n_model * mesh.n_data)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_model, None


def mesh_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` averaged over every process of a (data, model) ``mesh`` (an
    all-reduce over ``model``, then one over ``data`` if there are
    replicas), with the adjoint that gives the
    global loss's gradient under the sharded step. A process's ``x`` is
    ``1/N`` of the mean (N = n_data·n_model). The model ranks of a
    replica share one loss, so over ``model`` the cotangent is taken
    once, as `reduce_from_model` takes it; the step then averages every
    gradient over ``data``, which a replicated term (the MoE aux loss)
    must survive: each replica's ``x`` reaches the global loss, not only
    its own. So the cotangent a process takes is ``n_data/N = 1/n_model``
    of the mean's (the reference's GSPMD gradient of ``pmean`` over
    ``(model, data)``)."""
    return _MeshMean.apply(x, mesh)
