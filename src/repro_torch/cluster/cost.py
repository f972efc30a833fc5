"""Transition-traffic cost model for the global repack planner (port of
`repro/cluster/cost.py`): predict, in bytes, what a candidate `StagedPlan`
change would make the reshard engine move, before moving anything.

The prediction is computed from the same per-replica
`planner.TransitionPlan`s the live transition executes
(`reshard.transition.replica_transition_plans`), so for a model whose
per-unit byte sizes were calibrated from the live trees (`from_trees`, or
`from_rank_trees` on a process of a process-group run) the predicted total
equals the executed `TransferStats.bytes_moved` exactly. `analytic` prices
cluster-scale what-ifs from a `perf_model.Workload` instead.

``scaleup_bw`` (9e11 bytes/s, `perf_model.Hardware.scaleup_bw`, the
reference's default) is a parameter of the model, not a rate measured on
any card: the amortization gate divides by it, and the allocator's verdicts
equal the reference's only with the same value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.nonuniform import FailurePlan, StagedPlan

# the reference's default: perf_model.Hardware.scaleup_bw (a model
# parameter, bytes/s; the verdicts depend on it)
SCALEUP_BW = 9e11


@dataclass(frozen=True)
class TransitionCost:
    """One priced plan change: per-stage predicted traffic + wall time."""

    stage_bytes: Tuple[int, ...]
    scaleup_bw: float

    @property
    def total_bytes(self) -> int:
        return int(sum(self.stage_bytes))

    @property
    def seconds(self) -> float:
        return self.total_bytes / self.scaleup_bw


def _unit_bytes(cfg, trees, lead: int):
    """{(k, layer): payload bytes of one unit of the k-unit family in that
    layer}, summed over ``trees``: a unit leaf's axes after its ``lead``
    slot axes are one unit."""
    from repro_torch import tree as tr
    from repro_torch.reshard.units import ntp_unit_specs

    specs = ntp_unit_specs(cfg)
    out: Dict[Tuple[int, int], int] = {}
    for t in trees:
        for path, leaf in tr.leaves_with_path(t):
            spec = specs.get(tr.leaf_key(path))
            if spec is None:
                continue
            per_unit = int(np.prod(leaf.shape[lead:], dtype=np.int64)
                           ) * leaf.element_size()
            key = (spec.k, path[1])
            out[key] = out.get(key, 0) + per_unit
    return out


@dataclass(frozen=True)
class TransitionCostModel:
    """Bytes a packed→packed `StagedPlan` transition moves, per stage.

    ``family_layer_bytes[k]`` is the payload one moved unit of the k-unit
    family carries per layer, summed over every tree that rides the
    transition (params + each param-like optimizer tree: they share the
    fused messages, so their bytes add). Moved-unit counts come from the
    same `replica_transition_plans` the engine runs, which makes the
    prediction exact.
    """

    family_layer_bytes: Mapping[int, int]   # k -> bytes / moved unit / layer
    n_layers: int
    pp: int
    scaleup_bw: float = SCALEUP_BW

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_trees(cls, cfg, trees: Sequence[Dict], *, pp: int,
                   scaleup_bw: float = SCALEUP_BW) -> "TransitionCostModel":
        """Calibrate per-unit bytes from the live packed trees of the
        emulated session (params + param-like optimizer trees). Every unit
        leaf is (D, n1*buf, *unit); its per-unit payload is
        ``prod(unit) * itemsize``. Each layer contributes one identical set
        of leaves, so the per-layer figure is the tree-wide sum divided by
        ``cfg.n_layers`` (exact division)."""
        fam_total: Dict[int, int] = {}
        for (k, _), b in _unit_bytes(cfg, trees, 2).items():
            fam_total[k] = fam_total.get(k, 0) + b
        fam = {k: v // cfg.n_layers for k, v in fam_total.items()}
        assert all(fam[k] * cfg.n_layers == fam_total[k] for k in fam), (
            "unit leaves are not layer-uniform", fam_total)
        return cls(family_layer_bytes=fam, n_layers=cfg.n_layers, pp=pp,
                   scaleup_bw=scaleup_bw)

    @classmethod
    def from_rank_trees(cls, cfg, trees: Sequence[Dict], *, pp: int,
                        stage: Optional[int] = None,
                        scaleup_bw: float = SCALEUP_BW
                        ) -> "TransitionCostModel":
        """`from_trees` on one process of a process-group run, whose unit
        leaves are (buf, *unit). On a staged mesh (``stage``) the process
        holds only its stage's layers, so the per-layer figure is taken
        layer by layer over the layers it holds: each must give the same
        bytes, which are then the emulated session's figure (whose tree
        holds every layer)."""
        from repro_torch.core.ntp_train import stage_share

        own = set(stage_share(cfg, pp, stage)[0])
        per_layer: Dict[int, Dict[int, int]] = {}
        for (k, layer), b in _unit_bytes(cfg, trees, 1).items():
            per_layer.setdefault(k, {})[layer] = b
        fam = {}
        for k, by_layer in per_layer.items():
            assert set(by_layer) == own, (
                "unit leaves outside the process's layers", k, sorted(own),
                sorted(by_layer))
            assert len(set(by_layer.values())) == 1, (
                "unit leaves are not layer-uniform", k, by_layer)
            fam[k] = next(iter(by_layer.values()))
        return cls(family_layer_bytes=fam, n_layers=cfg.n_layers, pp=pp,
                   scaleup_bw=scaleup_bw)

    @classmethod
    def analytic(cls, wl, par, *, n_unit_families: int = 128,
                 bytes_per_param: int = 12,
                 scaleup_bw: float = SCALEUP_BW) -> "TransitionCostModel":
        """Cluster-scale pricing from a `perf_model.Workload` + `Parallel`:
        the model's parameters split evenly over ``n_unit_families`` units
        per layer; each moved unit drags params + AdamW moments
        (``bytes_per_param`` = 4 + 4 + 4 by default)."""
        per_layer = wl.n_params * bytes_per_param // (
            wl.n_layers * n_unit_families)
        return cls(family_layer_bytes={n_unit_families: int(per_layer)},
                   n_layers=wl.n_layers, pp=par.pp, scaleup_bw=scaleup_bw)

    # ------------------------------------------------------------ prediction

    def stage_bytes_for(self, old: FailurePlan, new: FailurePlan,
                        n_stage_layers: int) -> int:
        """Predicted traffic of one stage's transition (its layer slice)."""
        from repro_torch.reshard.transition import replica_transition_plans

        if new == old:
            return 0
        total = 0
        for k, layer_bytes in self.family_layer_bytes.items():
            moved = sum(p.n_moved for p in replica_transition_plans(k, old, new))
            total += moved * layer_bytes * n_stage_layers
        return total

    def predict(self, old: Optional[StagedPlan],
                new: StagedPlan) -> TransitionCost:
        """Price ``old → new``. ``old=None`` means a fresh packing (nothing
        in place yet): zero traffic by definition."""
        if old is None:
            return TransitionCost((0,) * new.pp, self.scaleup_bw)
        from repro_torch.configs.shapes import stage_boundaries

        assert old.pp == new.pp == self.pp, (old.pp, new.pp, self.pp)
        bounds = stage_boundaries(self.n_layers, self.pp)
        per_stage = tuple(
            self.stage_bytes_for(old.stages[s], new.stages[s],
                                 bounds[s + 1] - bounds[s])
            for s in range(self.pp)
        )
        return TransitionCost(per_stage, self.scaleup_bw)

    def predict_bytes(self, old: Optional[StagedPlan], new: StagedPlan) -> int:
        return self.predict(old, new).total_bytes

    def seconds(self, n_bytes: int) -> float:
        """``n_bytes`` over the model's ``scaleup_bw`` (not a measured rate)."""
        return n_bytes / self.scaleup_bw

