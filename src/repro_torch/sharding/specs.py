"""Parameter / optimizer-state sharding layouts (port of
`repro/sharding/specs.py`).

TP placement comes from each module's ``*_specs`` (Megatron layout, paper
§3.1; `models.transformer.Model.param_specs`). This module resolves those
specs against a mesh SHAPE (``{"data": d, "model": m}``) — dropping any
axis that does not divide its dim — and adds ZeRO-1 optimizer-state
sharding over the data-parallel axes. The results are spec trees
(`models.common.P` leaves) mirroring the parameter trees: the layouts that
sharded execution and the dry-run consume. The port runs one device per
step today, so nothing on its run path places a tensor by them yet.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch import tree as tr
from repro_torch.models.common import P, sanitize_spec


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
