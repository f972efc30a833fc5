"""Parameter / optimizer-state sharding layouts (port of
`repro/sharding/specs.py`).

TP placement comes from each module's ``*_specs`` (Megatron layout, paper
§3.1; `models.transformer.Model.param_specs`). This module resolves those
specs against a mesh SHAPE (``{"data": d, "model": m}``) — dropping any
axis that does not divide its dim — and adds ZeRO-1 optimizer-state
sharding over the data-parallel axes. The results are spec trees
(`models.common.P` leaves) mirroring the parameter trees.

Sharded execution (`train.steps.make_setup` on a `launch.mesh.RankMesh`)
places tensors by them: `local_shard` is the slice of a full tensor that
process (replica, rank) holds — a dim over ``model`` split by the rank, one
over ``data`` by the replica, a tuple of axes row-major in the order named
(``("data", "model")``: chunk ``replica * n_model + rank``), as a jax
``NamedSharding`` lays a spec over the reference's ``("data", "model")``
mesh; `place` maps it over a tree, `local_shape` gives a shard's shape,
and `gather` is the inverse, all-gathered over the mesh's groups (for
checks and checkpoints, never on a step's path).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.core.collectives import all_gather_units
from repro_torch.models.common import P, sanitize_spec

MESH_AXES = ("data", "model")


def param_shardings(mesh_shape: dict, spec_tree, shape_tree):
    """Spec tree + a tree of the same structure whose leaves have a
    ``.shape`` (tensors, or meta tensors) -> the sanitized spec tree."""
    return tr.tree_map(lambda spec, leaf: sanitize_spec(
        mesh_shape, tuple(leaf.shape), spec), spec_tree, shape_tree)


def zero1_spec(mesh_shape: dict, spec: P, shape: Tuple[int, ...],
               dp_axes=("data",)) -> P:
    """Extend a param spec with DP sharding on the largest eligible dim —
    ZeRO-1: optimizer moments are additionally partitioned across the
    data-parallel axis, cutting their footprint |dp|-fold."""
    dp = tuple(a for a in dp_axes if a in mesh_shape)
    dp_size = 1
    for a in dp:
        dp_size *= mesh_shape[a]
    if dp_size == 1 or not shape:
        return spec
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    # candidate dims: unsharded, divisible by dp_size; pick the largest
    cands = [
        (shape[d], d)
        for d, e in enumerate(entries)
        if e is None and shape[d] % dp_size == 0
    ]
    if not cands:
        return spec
    _, d = max(cands)
    entries[d] = dp if len(dp) > 1 else dp[0]
    return P(*entries)


def zero1_shardings(mesh_shape: dict, spec_tree, shape_tree,
                    dp_axes=("data",)):
    """`param_shardings`, then `zero1_spec` on each leaf."""
    def one(spec, leaf):
        shape = tuple(leaf.shape)
        return zero1_spec(mesh_shape, sanitize_spec(mesh_shape, shape, spec),
                          shape, dp_axes)

    return tr.tree_map(one, spec_tree, shape_tree)


# ---------------------------------------------------------------------------
# placement on a mesh of processes

def _axes(entry) -> Tuple[str, ...]:
    names = entry if isinstance(entry, tuple) else (entry,)
    bad = [a for a in names if a not in MESH_AXES]
    if bad:
        raise ValueError(f"spec axis {bad[0]!r}: a (data, model) mesh of "
                         f"processes has axes {MESH_AXES}")
    return names


def splits_over(spec: P, axis: str) -> bool:
    """Whether ``spec`` splits some dim over ``axis``."""
    return any(e is not None and axis in _axes(e) for e in tuple(spec))


def _coord(mesh, axis: str) -> Tuple[int, int]:
    """(this process's index, the axis size) on ``axis``."""
    return ((mesh.replica, mesh.n_data) if axis == "data"
            else (mesh.rank, mesh.n_model))


def _narrow(x, spec: P, mesh, only=MESH_AXES):
    """``x`` (a tensor or a numpy array) cut along every dim whose spec
    entry names only axes in ``only``: a view of the same kind."""
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = _axes(entry)
        if not set(names) <= set(only):
            continue
        idx, n = 0, 1
        for a in names:
            i, size = _coord(mesh, a)
            idx, n = idx * size + i, n * size
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways under {spec}")
        step = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(idx * step, (idx + 1) * step),)]
    return x


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of process (replica, rank)'s shard of a ``shape`` tensor
    under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(tuple(spec)):
        if entry is not None:
            n = 1
            for a in _axes(entry):
                n *= _coord(mesh, a)[1]
            out[dim] //= n
    return tuple(out)


def local_shard(full, spec: P, mesh):
    """The slice of ``full`` (a tensor or a numpy array, a memory map
    included) that this process holds under ``spec``: a view of the same
    kind."""
    return _narrow(full, spec, mesh)


def data_slice(x, spec: P, mesh):
    """The ``data`` cut alone of ``x`` (this process's ``model`` shard
    already): the ZeRO-1 slice of a param or a gradient that the process
    updates, a view."""
    return _narrow(x, spec, mesh, only=("data",))


def place(tree, specs, mesh, device=None):
    """`local_shard` over a tree, each shard a fresh contiguous tensor on
    ``device`` (the mesh's by default) that keeps nothing of the full
    tensor alive."""
    dev = mesh.device if device is None else torch.device(device)

    def one(a, s):
        x = local_shard(a, s, mesh)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x)).to(dev)
        return x.to(dev, copy=True).contiguous()

    return tr.tree_map(one, tree, specs)


def gather(tree, specs, mesh):
    """The inverse of `place`: every shard all-gathered into the full
    tensor on every process (over ``model`` and ``data``, the later axis
    of a tuple entry first). A collective: every process calls it with the
    same tree."""
    groups = {"data": mesh.data, "model": mesh.model}

    def one(x, spec):
        for dim, entry in enumerate(tuple(spec)):
            if entry is None:
                continue
            for a in reversed(_axes(entry)):
                parts = all_gather_units(x, groups[a])   # (n, *x.shape)
                x = parts.movedim(0, dim).reshape(
                    x.shape[:dim] + (-1,) + x.shape[dim + 1:])
        return x

    return tr.tree_map(one, tree, specs)
