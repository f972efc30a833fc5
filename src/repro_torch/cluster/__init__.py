"""repro_torch.cluster — the global repack planner (port of `repro.cluster`).

Given a `StagedHealth` ledger, search the joint assignment space stage-local
packing cannot reach (spares assignable to any stage, cross-stage domain
swaps at extreme skew, adaptive pack reordering) and emit a `GlobalPlan`
plus the ordered, cost-priced state-movement actions that realize it. Every
move is priced in the reshard engine's own `TransferStats` bytes and gated
by goodput amortization over a configurable horizon.
"""
from repro_torch.cluster.actions import Action
from repro_torch.cluster.allocator import (
    AllocatorConfig, GreedyAllocator, make_allocator,
)
from repro_torch.cluster.cost import TransitionCost, TransitionCostModel
from repro_torch.cluster.goodput import GoodputModel
from repro_torch.cluster.plan import GlobalPlan

__all__ = [
    "Action",
    "AllocatorConfig",
    "GlobalPlan",
    "GoodputModel",
    "GreedyAllocator",
    "TransitionCost",
    "TransitionCostModel",
    "make_allocator",
]
