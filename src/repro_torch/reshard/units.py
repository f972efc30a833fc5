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
(``kv_head``): leaves ``k``/``v`` of shape (..., T, kvh, hd), head axis -2,
one pair per cache group (``k.<g>``, ``k.t<j>`` where the layer pattern
has several entries; rings and full caches alike).
Mamba-2 state splits by SSD head (``ssm_head``): ``h`` (..., nh, hp, ds)
on axis -3, and ``conv`` (..., K-1, di + 2·ds) on axis -1 in blocks of hp
channels, with its B/C columns a replicated tail of 2·ds. RG-LRU state
splits by Griffin gate block (``rglru_block``): ``h`` (..., di) and
``conv`` (..., K-1, di) on axis -1 in blocks of ``block_width`` channels.
An enc-dec config's encoder K/V bank ``ek``/``ev`` (..., enc_seq, kvh, hd)
splits by head (``enc_kv_head``, axis -2) in every block kind.
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
        specs = {"k": kv, "v": kv}
    elif kind == "ssm":
        s = cfg.ssm
        nh = s.n_heads(cfg.d_model)
        specs = {
            "h": UnitSpec("ssm_head", nh, axis=-3),
            "conv": UnitSpec("ssm_head", nh, axis=-1, unit=s.head_dim,
                             tail=2 * s.d_state),
        }
    elif kind == "rglru":
        g = cfg.rglru
        w = g.block_width
        block = UnitSpec("rglru_block", g.d_inner(cfg.d_model) // w,
                         axis=-1, unit=w)
        specs = {"h": block, "conv": block}
    else:
        raise ValueError(f"no state units for block kind {kind!r}")
    if cfg.encoder is not None:
        # every enc-dec decoder block banks the encoder K/V: its heads
        # reshard as self-attention KV heads do, as their own family
        ekv = UnitSpec("enc_kv_head", cfg.n_kv_heads, axis=-2)
        specs = dict(specs, ek=ekv, ev=ekv)
    return specs


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
    """Leaf name → `UnitSpec` for ``cfg``'s cache dict
    (`models.transformer.cache_groups`): a bare name (``k``, ``h``) for a
    one-entry pattern, ``<name>.<g>`` for pattern entry ``g``'s group and
    ``<name>.t<j>`` for tail layer ``j`` (of kind ``layer_pattern[j]``).
    Unknown names raise: silently skipping a state leaf would strand it at
    the old layout through a TP transition."""
    pat = cfg.layer_pattern
    per_kind = {kind: _kind_state_specs(cfg, kind)
                for kind in dict.fromkeys(pat)}

    def resolve(name: str) -> UnitSpec:
        base, _, group = name.partition(".")
        entry = group[1:] if group.startswith("t") else group
        if len(pat) == 1 and not group:
            kind = pat[0]
        elif len(pat) > 1 and entry.isdigit() and int(entry) < len(pat):
            kind = pat[int(entry)]
        else:
            kind = None
        if kind is None or base not in per_kind[kind]:
            raise ValueError(
                f"unknown state leaf {name!r}: no UnitSpec registered for "
                f"{cfg.arch_id} (pattern {pat})"
            )
        return per_kind[kind][base]

    return resolve
