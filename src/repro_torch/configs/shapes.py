"""Assigned input shapes and the pipeline-stage geometry (port of
`repro/configs/shapes.py`): stage boundaries are data derived in one place,
so the stage-partitioned training step (`core.ntp_train`), the staged
session (`runtime.session`) and the analytic config search
(`core.perf_model.best_config`) can never disagree about which PP degrees
exist."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


#: PP degrees the stage-sequential step supports (powers of two, the ladder
#: the paper's Fig. 2 search walks). `candidate_pp` filters this by the
#: model's layer count; `core.perf_model.best_config` searches it.
SUPPORTED_PP: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


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


def candidate_pp(n_layers: int,
                 max_pp: int = SUPPORTED_PP[-1]) -> Tuple[int, ...]:
    """The supported PP degrees feasible for ``n_layers`` (every stage must
    own at least one layer) up to ``max_pp``."""
    return tuple(p for p in SUPPORTED_PP if p <= min(n_layers, max_pp))


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
