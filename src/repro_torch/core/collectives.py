"""Collectives of the process path (the port's counterpart of the
`jax.lax` collectives the reference calls inside shard_map).

* `psum` / `psum_` — ``jax.lax.psum`` over a group: `all_reduce` (sum);
  `psum_async_` issues it and returns a handle (the overlapped sync's).
* the Megatron pair, for per-rank autograd: `copy_to_model` is the identity
  forward and an all-reduce over the model group backward (at a block's
  input); `reduce_from_model` is an all-reduce forward and the identity
  backward (at a block's output). With the pair each rank's backward sees
  the full gradient of the replicated activations exactly once. The
  reference reaches the same result by seeding ``ct/n1`` on each model rank
  (`repro/core/overlap.py:36-45, :424`); an all-reduce whose backward is
  also an all-reduce counts the gradient n1 times.
* `all_to_all_units` — ``jax.lax.all_to_all`` with per-peer split sizes
  (`all_to_all_single`), the reshard's and the transitions' message route.
* `all_gather_units` — the canonical gather of a replica's unit buffers.
* `StageLink` — the pipeline hand-off of a staged mesh, ``jax.lax.ppermute``
  over ``stage`` and its transpose: `send_next` / `recv_prev` carry a
  boundary activation to the same (replica, rank) of the next stage,
  `send_prev` / `recv_next` its cotangent back.

Every call adds one to its (op, group) counter and its payload bytes to the
same counter (`counts`, `reset_counts`): an all-reduce's tensor, an
all-to-all's send buffer (the part to itself included), an all-gather's
input. A group is named by its ``group_desc`` (``"model"`` / ``"data"`` for
`launch.mesh.make_test_mesh`'s groups).

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
