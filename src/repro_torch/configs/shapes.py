"""Pipeline-stage geometry (port of the stage helpers of
`repro/configs/shapes.py`): stage boundaries are data derived in one place.
The port trains at pp=1, where the overlapped step's backward chunk ladder
(`core.overlap.chunk_ranges`) is the only user."""
from __future__ import annotations

from typing import Tuple


def stage_boundaries(n_layers: int, pp: int) -> Tuple[int, ...]:
    """Contiguous layer→stage split: ``pp + 1`` boundaries; stage ``s`` owns
    layers ``[b[s], b[s+1])``. Balanced: the first ``n_layers % pp`` stages
    take one extra layer, so no stage is ever empty."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if pp > n_layers:
        raise ValueError(
            f"pp={pp} exceeds n_layers={n_layers}: a pipeline stage with no "
            "layers has nothing to compute"
        )
    base, extra = divmod(n_layers, pp)
    bounds = [0]
    for s in range(pp):
        bounds.append(bounds[-1] + base + (1 if s < extra else 0))
    return tuple(bounds)


def layer_stages(n_layers: int, pp: int) -> Tuple[int, ...]:
    """Owning stage per layer (inverse view of `stage_boundaries`)."""
    bounds = stage_boundaries(n_layers, pp)
    out = []
    for s in range(pp):
        out.extend([s] * (bounds[s + 1] - bounds[s]))
    return tuple(out)
