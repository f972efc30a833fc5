"""Partition-unit specs (port of `repro/reshard/units.py`).

A `UnitSpec` says how one leaf of a state tree splits into Algorithm-1
partition units: ``k`` units along leaf axis ``axis``. Training weights are
already unit-buffered when they reach the engine, so their specs carry only
``kind``/``k``: the GQA kv-group (``kv_group``) of the attention weights and
the 128-row block (``rows128``) of the dense MLP, or the whole expert
(``expert``) of an MoE FFN (`ntp_unit_specs`).
Serving state trees are dense, so their specs also carry the leaf
geometry: ``unit`` channels per unit along ``axis`` and a replicated
``tail`` that never moves. Served attention caches split by GQA KV head
(``kv_head``): leaves ``k``/``v`` of shape (..., T, kvh, hd), head axis -2.
Mamba-2 state splits by SSD head (``ssm_head``): ``h`` (..., nh, hp, ds)
on axis -3, and ``conv`` (..., K-1, di + 2·ds) on axis -1 in blocks of hp
channels, with its B/C columns a replicated tail of 2·ds. The rgLRU-block family
waits for its slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from repro_torch.configs.base import ATTN_KINDS, ArchConfig


@dataclass(frozen=True)
class UnitSpec:
    """One partition-unit family on one leaf."""

    kind: str
    k: int            # number of partition units
    axis: int = 0     # leaf axis carrying the units (negative = from end)
    unit: int = 1     # channels per unit along that axis
    tail: int = 0     # trailing replicated channels (never resharded)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"UnitSpec needs k >= 1, got {self}")


def ntp_unit_specs(cfg) -> Dict[str, UnitSpec]:
    """Leaf-name → UnitSpec for the NTP prototype's packed param/opt trees
    (``cfg``: `core.ntp_train.NTPModelConfig`, duck-typed to avoid an import
    cycle): the MLP unit is the whole expert of an MoE config, else the row
    block. Leaves not named here are replicated (norms, embed, head,
    router)."""
    mlp_kind = "expert" if cfg.is_moe else "rows128"
    attn = UnitSpec("kv_group", cfg.n_kv_groups)
    mlp = UnitSpec(mlp_kind, cfg.k_ff)
    return {"wq": attn, "wk": attn, "wv": attn, "wo": attn, "A": mlp, "B": mlp}


def _kind_state_specs(cfg: ArchConfig, kind: str) -> Dict[str, UnitSpec]:
    """State-leaf specs of one block kind."""
    if kind in ATTN_KINDS:
        kv = UnitSpec("kv_head", cfg.n_kv_heads, axis=-2)
        return {"k": kv, "v": kv}
    if kind == "ssm":
        s = cfg.ssm
        nh = s.n_heads(cfg.d_model)
        return {
            "h": UnitSpec("ssm_head", nh, axis=-3),
            "conv": UnitSpec("ssm_head", nh, axis=-1, unit=s.head_dim,
                             tail=2 * s.d_state),
        }
    raise ValueError(f"no state units for block kind {kind!r} in the port")


def arch_unit_counts(cfg: ArchConfig) -> Dict[str, int]:
    """Partition-unit count per state family present in ``cfg``'s pattern."""
    out: Dict[str, int] = {}
    for kind in dict.fromkeys(cfg.layer_pattern):
        for spec in _kind_state_specs(cfg, kind).values():
            out[spec.kind] = spec.k
    return out


def serve_unit_count(cfg: ArchConfig) -> int:
    """The quantization granularity serving slowdown models use: the
    COARSEST (smallest-k) unit family in the pattern pins the imbalance."""
    return max(1, min(arch_unit_counts(cfg).values()))


def cache_unit_resolver(cfg: ArchConfig) -> Callable[[str], UnitSpec]:
    """Leaf name → `UnitSpec` for ``cfg``'s cache dict. Unknown names raise:
    silently skipping a state leaf would strand it at the old layout
    through a TP transition."""
    specs: Dict[str, UnitSpec] = {}
    for kind in dict.fromkeys(cfg.layer_pattern):
        specs.update(_kind_state_specs(cfg, kind))

    def resolve(name: str) -> UnitSpec:
        if name not in specs:
            raise ValueError(
                f"unknown state leaf {name!r}: no UnitSpec registered for "
                f"{cfg.arch_id} (have {sorted(specs)})"
            )
        return specs[name]

    return resolve
