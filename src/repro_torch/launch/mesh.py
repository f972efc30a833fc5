"""The (data, model) mesh as process groups (port of
`repro/launch/mesh.py::make_test_mesh`).

The reference lays its devices out as a ``("data", "model")`` jax mesh and
runs the training step under shard_map. The port's process path runs one
process per (replica, rank): global rank ``replica * n_model + rank``, as
the reference's row-major mesh. Each process joins two groups:

* ``model`` — the ``n_model`` processes of its replica, the scale-up domain
  (the reshard all-to-all and the Megatron pair's all-reduce);
* ``data`` — the ``n_data`` processes holding the same model rank of every
  replica (the gradient sum, ``psum('data')``).

The groups are plain `new_subgroups_by_enumeration` groups: a 2-D
`DeviceMesh` binds one device to each process, and on one card every
process of a gloo run shares ``cuda:0``. ``backend`` is the caller's choice,
never inferred: ``"nccl"`` needs one CUDA device per process and raises
with fewer; ``"gloo"`` takes CPU tensors, or CUDA tensors on a shared card.

`make_production_mesh` (port of `repro/launch/mesh.py::
make_production_mesh`) is the dry-run's: ONE process plays one (replica,
rank) of the 16 × 16 production mesh on ``meta`` tensors, in a world of
256 joined through PyTorch's counting-only ``fake`` backend, whose
collectives move nothing and return at once (`launch.dryrun`).

`make_staged_mesh` (port of `repro/launch/mesh.py::make_staged_mesh`) lays
``pp * n_data * n_model`` processes out as the reference's ``("stage",
"data", "model")`` mesh, row-major: global rank ``s * (n_data * n_model) +
d * n_model + r``. The ``model`` and ``data`` groups are then per stage (a
stage's scale-up domains and its gradient sum), and a third group, ``stage``,
joins the ``pp`` processes of one (replica, rank) across the stages: the
pipeline hand-off's peers (`core.collectives.StageLink`), the loss sum and
the canonical gather.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class RankMesh:
    """This process's place in a (data=n_data, model=n_model) mesh of
    processes, its groups and its device. On a staged mesh
    (`make_staged_mesh`, ``pp > 1``) it is stage ``stage``'s slice: ``data``
    and ``model`` are that stage's groups and ``pipe`` joins this (replica,
    rank) across the stages."""

    n_data: int
    n_model: int
    replica: int
    rank: int
    data: dist.ProcessGroup
    model: dist.ProcessGroup
    device: torch.device
    backend: str
    stage: int = 0
    pp: int = 1
    pipe: Optional[dist.ProcessGroup] = None

    def __iter__(self):
        """``tuple(mesh)`` is the (per-stage) mesh shape ``(n_data,
        n_model)``, as the emulated path's ``mesh`` argument."""
        return iter((self.n_data, self.n_model))

    @property
    def global_rank(self) -> int:
        return (self.stage * self.n_data + self.replica) * self.n_model \
            + self.rank

    @property
    def axis_names(self):
        """The reference's mesh axes: ``("stage", "data", "model")`` on a
        staged mesh, else ``("data", "model")``."""
        return (("stage",) if self.pp > 1 else ()) + ("data", "model")

    @property
    def shape(self):
        """Axis sizes by name, as a jax mesh's ``shape``."""
        out = {"stage": self.pp} if self.pp > 1 else {}
        return dict(out, data=self.n_data, model=self.n_model)

    def stage_peer(self, stage: int) -> int:
        """The global rank of this (replica, rank) in stage ``stage``."""
        return (stage * self.n_data + self.replica) * self.n_model + self.rank


def check_backend(backend: str, world: int,
                  device: Union[str, torch.device]) -> torch.device:
    """The device a process of a ``world``-process run on ``backend`` uses
    (before any rank is known: CUDA index 0 stands for the local rank's
    card under NCCL). Raises for an unknown backend, for NCCL on the CPU,
    and for NCCL with fewer CUDA devices than processes (NCCL refuses two
    ranks on one device)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the ranks on the CPU")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA tensors: use "
                             "backend='gloo' for device='cpu'")
        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"backend 'nccl' needs one CUDA device per process: {world} "
                f"processes, {torch.cuda.device_count()} devices (use "
                f"backend='gloo' to share one card)")
    return dev


def make_test_mesh(n_data: int = 2, n_model: int = 4, *, backend: str,
                   device: Union[str, torch.device]) -> RankMesh:
    """This process's `RankMesh` over the initialized default group of
    ``n_data * n_model`` processes (`launch.spawn`). Every process must call
    it, in the same order as every other group it makes. Under NCCL each
    process takes the card of its local rank; under gloo every process uses
    ``device`` as given."""
    dev = _joined(n_data * n_model, f"mesh ({n_data}, {n_model})", backend,
                  device)
    replica, rank = divmod(dist.get_rank(), n_model)
    model, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + r for r in range(n_model)] for d in range(n_data)],
        backend=backend, group_desc="model")
    data, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + r for d in range(n_data)] for r in range(n_model)],
        backend=backend, group_desc="data")
    return RankMesh(n_data, n_model, replica, rank, data, model, dev, backend)


PRODUCTION_SHAPE = (16, 16)


def make_production_mesh(multi_pod: bool = False, *, replica: int = 0,
                         rank: int = 0, shape=None) -> RankMesh:
    """This process as ``(replica, rank)`` of the production mesh: 256
    chips, (data 16, model 16), the ``model`` axis the scale-up domain
    (the paper's NVL domain). Its groups are the ``fake`` backend's (every
    collective returns at once, nothing moves; `core.collectives` still
    counts its calls and bytes) and its device is ``meta``: the dry-run's
    mesh, shapes only. It makes this process's default group a fake world
    of ``n_data * n_model`` (replacing an earlier fake one; a real one
    raises); the caller ends it with `close_fake_mesh`.

    ``multi_pod`` (2 pods, 512 chips) folds the reference's ``pod`` ×
    ``data`` axes into one ``data`` group of 32: each rank's counts are
    those of the reference's gradient reduction over ``('pod', 'data')``,
    one group of 32 rather than a reduction over two axes. ``shape``
    (``(n_data, n_model)``) sizes a smaller fake mesh for checks against a
    real run of that size."""
    n_data, n_model = (shape if shape is not None else
                       (PRODUCTION_SHAPE[0] * (2 if multi_pod else 1),
                        PRODUCTION_SHAPE[1]))
    if not (0 <= replica < n_data and 0 <= rank < n_model):
        raise ValueError(f"(replica {replica}, rank {rank}) outside the "
                         f"({n_data}, {n_model}) mesh")
    # the counting-only backend sits under torch.testing: import it only
    # where a dry-run asks for it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} default group exists: the "
                "dry-run's fake world needs a process of its own")
        dist.destroy_process_group()
    n = n_data * n_model
    dist.init_process_group("fake", store=FakeStore(),
                            rank=replica * n_model + rank, world_size=n)
    model, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + r for r in range(n_model)] for d in range(n_data)],
        backend="fake", group_desc="model")
    data, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + r for d in range(n_data)] for r in range(n_model)],
        backend="fake", group_desc="data")
    return RankMesh(n_data, n_model, replica, rank, data, model,
                    torch.device("meta"), "fake")


def close_fake_mesh() -> None:
    """End the fake world of `make_production_mesh` (and its groups)."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def dp_axes(mesh) -> tuple:
    """The mesh's data-parallel axes: every axis but ``model`` and
    ``stage``, as the reference's `dp_axes` (its ``pod`` axis is folded
    into ``data`` here)."""
    return tuple(a for a in mesh.axis_names if a not in ("model", "stage"))


def _joined(world: int, what: str, backend: str, device) -> torch.device:
    """Check the default group against a ``world``-process mesh and return
    this process's device (set as current on CUDA)."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: start the ranks with "
                           "repro_torch.launch.spawn (or torchrun)")
    if dist.get_world_size() != world:
        raise ValueError(f"{what} needs {world} processes, the group has "
                         f"{dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the default group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    dev = check_backend(backend, world, device)
    if backend == "nccl":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    elif dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_staged_mesh(pp: int, n_data: int = 2, n_model: int = 4, *,
                     backend: str, device: Union[str, torch.device]
                     ) -> RankMesh:
    """This process's `RankMesh` on a ``(stage=pp, data=n_data,
    model=n_model)`` mesh of the initialized default group of ``pp * n_data
    * n_model`` processes, global rank ``s * (n_data * n_model) + d *
    n_model + r``. Stage ``s``'s layers live only on its processes; its
    ``model`` and ``data`` groups are its own, and ``pipe`` (``"stage"``)
    joins one (replica, rank) across the stages. Every process must call
    it, in the same order as every other group it makes. Raises for
    ``pp < 2`` (the 2-D `make_test_mesh` is the stage-sequential route) and
    for a group of another size."""
    if pp < 2:
        raise ValueError(
            f"pp={pp}: a staged mesh needs >= 2 stages; use make_test_mesh "
            "(the stage-sequential route) for pp=1")
    n = pp * n_data * n_model
    dev = _joined(n, f"staged mesh (stage={pp}, data={n_data}, "
                  f"model={n_model})", backend, device)
    stage, rest = divmod(dist.get_rank(), n_data * n_model)
    replica, rank = divmod(rest, n_model)

    def g(s, d, r):
        return (s * n_data + d) * n_model + r

    model, _ = dist.new_subgroups_by_enumeration(
        [[g(s, d, r) for r in range(n_model)]
         for s in range(pp) for d in range(n_data)],
        backend=backend, group_desc="model")
    data, _ = dist.new_subgroups_by_enumeration(
        [[g(s, d, r) for d in range(n_data)]
         for s in range(pp) for r in range(n_model)],
        backend=backend, group_desc="data")
    pipe, _ = dist.new_subgroups_by_enumeration(
        [[g(s, d, r) for s in range(pp)]
         for d in range(n_data) for r in range(n_model)],
        backend=backend, group_desc="stage")
    return RankMesh(n_data, n_model, replica, rank, data, model, dev, backend,
                    stage=stage, pp=pp, pipe=pipe)
