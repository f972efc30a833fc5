"""Typed state-movement actions the allocator emits (port of
`repro/cluster/actions.py`; pure Python).

Two layers of actions live in a `GlobalPlan`:

* **decisions** (``spare`` / ``swap``) — the search moves the allocator
  accepted, each carrying the marginal goodput gain and the marginal priced
  transfer cost that justified it (the amortization gate's ledger);
* **transitions** — the ordered per-stage state movements executing the
  final plan against the session's current layout, each carrying the
  predicted traffic the reshard engine will put on the wire (and, for
  reordering, the stage's new pack permutation).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Action:
    """One allocator move, priced.

    ``gain_s`` is the useful-compute seconds the move recovers over the
    allocator's horizon; ``cost_s`` the marginal transfer seconds it adds.
    Every emitted non-rescue action has ``cost_s <= gain_s``. ``rescue``
    marks moves that revive a dead replica — the job is halted without
    them, so amortization does not apply.
    """

    kind: str                                # "spare" | "swap" | "transition"
    gain_s: float = 0.0
    cost_s: float = 0.0
    bytes: int = 0                           # marginal predicted traffic
    rescue: bool = False
    site: Optional[Tuple[int, int]] = None   # (stage, domain) acted on
    other: Optional[Tuple[int, int]] = None  # swap partner site
    absorbed: int = 0                        # failures a spare soaks up
    stage: Optional[int] = None              # transition: stage that moves
    order: Optional[Tuple[int, ...]] = None  # transition: pack permutation
    note: str = ""

    def __post_init__(self):
        assert self.kind in ("spare", "swap", "transition"), self.kind
        assert self.bytes >= 0 and self.cost_s >= 0.0, self
