"""Cost analysis of one step as the port executes it — the counterpart of
`repro/launch/hlo_analysis.py`.

The reference parses the optimized (post-SPMD) XLA HLO of a compiled step.
The port compiles nothing: it runs eager ATen ops, the hand-written
kernels and `core.collectives`, so `analyze_step` runs the step once
(usually on ``meta`` tensors over the dry-run's fake process groups,
`launch.mesh.make_production_mesh`) and counts what it executes:

  flops  — the ATen ops' FLOPs as `torch.utils.flop_counter.FlopCounterMode`
           counts them (matrix products, convolutions and attention; no
           elementwise op), plus each hand kernel's own cost function
           (`kernels.mode.dry_launches` on meta; a kernel launched on a card
           is counted by `launches` and adds nothing here).
  bytes  — each ATen op's inputs and outputs (views, which move nothing,
           and empty allocations skipped), plus each kernel's cost bytes.
           Nothing is fused, so this is larger than the reference's HLO
           bytes for the same step, where XLA fuses elementwise chains:
           compare FLOPs, not bytes, with the reference.
  colls  — `core.collectives.counts()` of the step, (calls, bytes) per
           (op, group), with the reference's ring formulas for the bytes
           each moves (`_coll_moved`, copied from hlo_analysis.py).

Everything is per process (one rank of the mesh). A Python loop runs
every iteration, so there is no counterpart of the reference's
``unknown_trip_count_loops`` (an XLA while loop without a known trip
count); `analyze_step` leaves that key out. Per-cycle remat recomputes the
forward inside the backward, and it is counted there, as XLA's HLO counts
it.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import collectives as C
from repro_torch.kernels import mode

# the port's collective ops under the reference's HLO opcode names;
# a pipeline receive is the far half of the send it pairs with, moving
# nothing of its own
HLO_OPS = {
    "all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
    "all_gather": "all-gather", "all_to_all": "all-to-all",
    "reduce_scatter": "reduce-scatter",
    "send_next": "collective-permute", "send_prev": "collective-permute",
    "recv_prev": None, "recv_next": None, "broadcast": "broadcast",
}

# allocations that read and write nothing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _coll_moved(op: str, rbytes: float, n: int) -> float:
    """Bytes one device moves for a collective of ``rbytes`` result bytes
    over a group of ``n`` (ring model; `repro/launch/hlo_analysis.py::
    _coll_moved`)."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * rbytes * (n - 1) / n
    if op == "all-gather":
        return rbytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(rbytes) * (n - 1)
    if op == "all-to-all":
        return rbytes * (n - 1) / n
    return float(rbytes)  # collective-permute


def collectives_from_counts(counts: Mapping, group_sizes: Mapping[str, int]
                            ) -> Dict[str, Dict[str, float]]:
    """`core.collectives.counts()` as the reference's per-opcode table:
    ``count``, ``moved_bytes`` and ``result_bytes`` by HLO opcode. A
    counted all-gather's bytes are its input (one peer's part): its
    result is ``n`` times that; a reduce-scatter's are its input, its
    result ``1/n`` of that."""
    out: Dict[str, Dict[str, float]] = {}
    for (op, group), (calls, nbytes) in sorted(counts.items()):
        hlo = HLO_OPS[op]
        if hlo is None:
            continue
        n = group_sizes[group]
        rbytes = (nbytes * n if hlo == "all-gather" else
                  nbytes / n if hlo == "reduce-scatter" else nbytes)
        d = out.setdefault(hlo, {"count": 0.0, "moved_bytes": 0.0,
                                 "result_bytes": 0.0})
        d["count"] += calls
        d["result_bytes"] += rbytes
        # the counted bytes are summed over the calls; every formula is
        # linear in the result bytes, so the sum moves as the calls do
        d["moved_bytes"] += _coll_moved(hlo, rbytes, n)
    return out


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    """True for an op whose every output aliases an input without writing
    it (a view: no bytes move)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _scope() -> str:
    """The innermost function of the port on the Python stack (``module.
    function``, the package prefix dropped), or ``backward`` inside the
    autograd engine."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith("repro_torch.") and name != __name__:
            return f"{name[len('repro_torch.'):]}.{f.f_code.co_name}"
        f = f.f_back
    return "backward"


class _OpCounter(TorchDispatchMode):
    """Bytes and FLOPs of every ATen op, by ``op:scope`` key. FLOPs are
    read off the enclosing `FlopCounterMode` around each op, so the rows
    sum to its total."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.rows: Dict[str, Dict[str, float]] = {}
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self.flops.get_total_flops()
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _NO_TRAFFIC or _is_view(func):
            nbytes = 0
        else:
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        flops = self.flops.get_total_flops() - before
        if nbytes or flops:
            self.bytes += nbytes
            row = self.rows.setdefault(f"{name}:{_scope()}",
                                       {"bytes": 0.0, "flops": 0.0,
                                        "count": 0})
            row["bytes"] += nbytes
            row["flops"] += flops
            row["count"] += 1
        return out


class _SavedBytes:
    """Bytes the forward saves for the backward (`saved_tensors_hooks`),
    each storage once, the step's own arguments (params, state) left out;
    saves made inside the backward (remat's recompute) are not counted."""

    def __init__(self, args):
        self.skip = {t.untyped_storage()._cdata
                     for t in tree_flatten(args)[0]
                     if isinstance(t, torch.Tensor)}
        self.seen = set()
        self.bytes = 0

    def pack(self, t):
        if torch._C._current_graph_task_id() == -1:
            s = t.untyped_storage()
            if s._cdata not in self.skip and s._cdata not in self.seen:
                self.seen.add(s._cdata)
                self.bytes += s.nbytes()
        return t

    @staticmethod
    def unpack(t):
        return t


def analyze_step(fn: Callable, *args,
                 group_sizes: Optional[Mapping[str, int]] = None) -> Dict:
    """Run ``fn(*args)`` once, counting what it executes. Returns the
    reference's `analyze_hlo` keys that have a meaning here — ``flops``,
    ``bytes``, ``collective_moved_bytes``, ``collectives`` (HLO opcode →
    ``count``, ``moved_bytes``, ``result_bytes``) — and the port's own:
    ``calls`` (``{(op, group): (calls, bytes)}`` of `core.collectives`),
    ``kernels`` (the hand kernels' meta calls and costs), ``aten_flops``
    (FlopCounterMode alone), ``saved_bytes`` (held for the backward),
    ``rows`` (per ``op:scope``, for `top_contributors`) and ``result``
    (what ``fn`` returned). ``group_sizes`` maps each group name the step
    uses to its size (`group_sizes` of a mesh)."""
    C.reset_counts()
    mode.reset_dry_launches()
    saved = _SavedBytes(args)
    with FlopCounterMode(display=False) as fc, _OpCounter(fc) as ops, \
            torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                     saved.unpack):
        result = fn(*args)
    calls = C.counts()
    kernels = mode.dry_launches()
    colls = collectives_from_counts(calls, group_sizes or {})
    aten = fc.get_total_flops()
    rows = dict(ops.rows)
    for name, k in kernels.items():
        rows[f"{name}:kernel"] = {"bytes": float(k["bytes"]),
                                  "flops": float(k["flops"]),
                                  "count": k["calls"]}
    return {
        "flops": float(aten + sum(k["flops"] for k in kernels.values())),
        "bytes": float(ops.bytes + sum(k["bytes"] for k in kernels.values())),
        "collective_moved_bytes": sum(c["moved_bytes"]
                                      for c in colls.values()),
        "collectives": colls,
        "calls": calls,
        "kernels": kernels,
        "aten_flops": float(aten),
        "saved_bytes": saved.bytes,
        "rows": rows,
        "result": result,
    }


def group_sizes(mesh) -> Dict[str, int]:
    """Each group's size on a `launch.mesh.RankMesh`, by `core.collectives`
    group name."""
    sizes = {"model": mesh.n_model, "data": mesh.n_data}
    if getattr(mesh, "pp", 1) > 1:
        sizes["stage"] = mesh.pp
    return sizes


def top_contributors(analysis: Dict, n: int = 25) -> List[dict]:
    """The ``n`` largest rows of an `analyze_step` result by bytes: ``key``
    (``aten op:scope``, the innermost function of the port that issued it,
    or ``kernel:kernel`` for a hand kernel's meta calls — the counterpart
    of the reference's ``opcode:jax_op_name``), ``bytes``, ``flops`` and
    ``count``."""
    out = [dict(key=k, **v) for k, v in analysis["rows"].items()]
    out.sort(key=lambda d: -d["bytes"])
    return out[:n]


def roofline(flops: float, nbytes: float, coll_bytes: float, *,
             peak_flops: float, hbm_bw: float, link_bw: float) -> Dict[str,
                                                                     Any]:
    """Compute, memory and collective seconds of one step at the given
    peaks, and the largest of them (``dominant``)."""
    t_comp, t_mem, t_coll = (flops / peak_flops, nbytes / hbm_bw,
                             coll_bytes / link_bw)
    dom = max((t_comp, "compute"), (t_mem, "memory"),
              (t_coll, "collective"))[1]
    return {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
            "dominant": dom}
