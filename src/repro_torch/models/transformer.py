"""Model assembly for the serving path: decoder-only stacks of attention
blocks (full, sliding-window or chunked, mixed in a layer pattern) with a
dense or Mixture-of-Experts FFN, or of Mamba-2 SSD blocks (port of
`repro/models/transformer.py`).

Parameters are a plain dict in the reference's layout — ``embed`` (vp, d),
``lm_head`` (d, vp) unless the embeddings are tied, ``final_norm.w`` and one
block dict per layer in ``layers`` (a list: a Python loop over layers
replaces ``lax.scan``), with every weight kept ``(in, out)``.

The cache is a flat dict of leaves grouped as the reference's cache tree
groups them (`cache_groups`): one group per layer-pattern entry, stacking
that entry's layers of every full pattern cycle on a leading axis, and one
group per leftover ("tail") layer. A pattern of one entry keeps the bare
leaf names — ``{"k", "v"}`` with leaves (layers, batch, T, kvh, hd) for
attention, ``{"h", "conv"}`` with leaves (layers, batch, nh, hp, ds) and
(layers, batch, K-1, di+2ds) for Mamba-2; a longer pattern suffixes each
name with its group (``k.0`` … ``k.3``, ``k.t0`` for tail layer 0), since
its groups may differ in kind and ring length. For continuous batching the
batch axis is the slot axis, and `decode_slots` advances every slot at its
own position in one batched step (the slot dimension written out where the
reference vmaps). Caches are updated in place.

RMSNorm (ln1, ln2, the post-norms ln1_post/ln2_post of a post-norm
block, final_norm, the SSD gated norm) runs the hand-written
`kernels.rmsnorm`; prefill attention runs `kernels.flash_attention`; the
SSD prefill scan runs `kernels.ssd_scan`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_KINDS, ArchConfig
from repro_torch.kernels import mode
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import embed_init, softcap


# ---------------------------------------------------------------------------
# norms

def norm_init(cfg: ArchConfig, dtype, device) -> dict:
    # gemma-style (1+w): init w to zero
    return {"w": torch.zeros(cfg.d_model, dtype=dtype, device=device)}


def norm_apply(cfg: ArchConfig, p: dict, x):
    flat = x.reshape(-1, x.shape[-1])
    return rmsnorm(flat, p["w"], eps=cfg.norm_eps, plus_one=True).reshape(x.shape)


# ---------------------------------------------------------------------------
# blocks

def _has_ffn(cfg: ArchConfig, kind: str) -> bool:
    return cfg.d_ff > 0 and kind != "ssm"


def _moe_ffn(cfg: ArchConfig, kind: str) -> bool:
    return cfg.moe is not None and kind in ATTN_KINDS


def block_init(cfg: ArchConfig, gen: torch.Generator, dtype,
               kind: str) -> dict:
    p = {"ln1": norm_init(cfg, dtype, gen.device)}
    if kind == "ssm":
        p["mixer"] = ssm_mod.ssm_init(cfg, gen, dtype)
    else:
        p["mixer"] = attn_mod.attn_init(cfg, gen, dtype)
    if cfg.post_norms:
        p["ln1_post"] = norm_init(cfg, dtype, gen.device)
    if _has_ffn(cfg, kind):
        p["ln2"] = norm_init(cfg, dtype, gen.device)
        if _moe_ffn(cfg, kind):
            p["ffn"] = mlp_mod.moe_init(cfg, gen, dtype)
        else:
            p["ffn"] = mlp_mod.mlp_init(cfg, gen, dtype)
        if cfg.post_norms:
            p["ln2_post"] = norm_init(cfg, dtype, gen.device)
    return p


def block_apply(cfg: ArchConfig, p: dict, x, *, kind: str,
                cache: Optional[dict], cache_pos, slots: bool = False):
    """Returns (x, cache). ``slots``: ``x`` is a decode tick of one token a
    serving slot, and an MoE FFN dispatches each slot on its own
    (`mlp.moe_apply_slots`); otherwise its capacity is per call. A
    post-norm block (gemma2) normalizes the mixer's and the FFN's output
    before its residual add."""
    h = norm_apply(cfg, p["ln1"], x)
    if kind == "ssm":
        out, cache = ssm_mod.ssm_apply(cfg, p["mixer"], h, cache=cache,
                                       cache_pos=cache_pos)
    else:
        out, cache = attn_mod.attn_apply(
            cfg, p["mixer"], h, kind=kind, cache=cache, cache_pos=cache_pos,
        )
    if cfg.post_norms:
        out = norm_apply(cfg, p["ln1_post"], out)
    x = x + out
    if _has_ffn(cfg, kind):
        h2 = norm_apply(cfg, p["ln2"], x)
        if not _moe_ffn(cfg, kind):
            out = mlp_mod.mlp_apply(cfg, p["ffn"], h2)
        elif slots:
            out = mlp_mod.moe_apply_slots(cfg, p["ffn"], h2)
        else:
            out = mlp_mod.moe_apply(cfg, p["ffn"], h2)[0]
        if cfg.post_norms:
            out = norm_apply(cfg, p["ln2_post"], out)
        x = x + out
    return x, cache


SERVED_ATTN_KINDS = ("attn", "attn_sw", "attn_chunked")


def validate_model_cfg(cfg: ArchConfig) -> None:
    """The blocks the port runs so far: causal self-attention with RoPE —
    full, sliding-window or chunked, in any pattern — and a dense or MoE
    FFN, or Mamba-2 SSD blocks (no FFN, no RoPE), with RMSNorm, pre-norm
    or with post-norms too (gemma2). Other archs wait for their slices."""
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    what = f"{cfg.arch_id}: the port serves"
    if cfg.encoder is not None:
        raise ValueError(f"{what} decoder-only stacks so far; got an encoder")
    if cfg.norm_type != "rms":
        raise ValueError(f"{what} RMSNorm only so far; got norm_type="
                         f"{cfg.norm_type!r}")
    if kinds <= set(SERVED_ATTN_KINDS):
        if cfg.d_ff > 0 and cfg.use_rope:
            return
    elif kinds == {"ssm"}:
        if (cfg.ssm is not None and cfg.d_ff == 0 and cfg.moe is None
                and not cfg.use_rope):
            return
    raise ValueError(
        f"{what} full-attention decoders, with sliding-window and chunked "
        f"layers in any pattern ({SERVED_ATTN_KINDS}), RoPE and a dense or "
        f"MoE FFN, and Mamba-2 SSD stacks (d_ff=0, no RoPE, no MoE), so "
        f"far; got kinds {sorted(kinds)}, moe={cfg.moe is not None}, "
        f"d_ff={cfg.d_ff}, use_rope={cfg.use_rope}"
    )


def cache_groups(cfg: ArchConfig) -> List[Tuple[str, str, List[int]]]:
    """The cache's layer groups as the reference's cache tree holds them:
    (leaf-name suffix, block kind, layer indices), one group per pattern
    entry over the full cycles, then one per tail layer. A one-entry
    pattern has no tail and its suffix is empty."""
    pat = cfg.layer_pattern
    n_cyc, n_tail = divmod(cfg.n_layers, len(pat))
    if len(pat) == 1:
        return [("", pat[0], list(range(cfg.n_layers)))]
    groups = [(f".{g}", kind, list(range(g, n_cyc * len(pat), len(pat))))
              for g, kind in enumerate(pat) if n_cyc]
    return groups + [(f".t{j}", pat[j], [n_cyc * len(pat) + j])
                     for j in range(n_tail)]


# ---------------------------------------------------------------------------
# model

class Model:
    """Functional model bundle for one architecture on one device."""

    def __init__(self, cfg: ArchConfig, *, param_dtype=torch.float32,
                 device=None):
        validate_model_cfg(cfg)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.device = mode.resolve_device(device)
        # layer i's cache: (leaf-name suffix, index on the group's axis)
        self._cache_at: List[Optional[Tuple[str, int]]] = [None] * cfg.n_layers
        for sfx, _, layers in cache_groups(cfg):
            for j, i in enumerate(layers):
                self._cache_at[i] = (sfx, j)

    # ---- params ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator`` on its device (which
        must be the model's)."""
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator on {generator.device}, model on {self.device}"
            )
        cfg, dt = self.cfg, self.param_dtype
        vp = cfg.padded_vocab()
        params: Dict[str, Any] = {
            "embed": embed_init(generator, (vp, cfg.d_model), dt),
            "final_norm": norm_init(cfg, dt, self.device),
            "layers": [block_init(cfg, generator, dt, cfg.block_kind(i))
                       for i in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(generator, (cfg.d_model, vp), dt)
        return params

    # ---- caches ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
        """Every layer's state, by `cache_groups` (an SSD state does not
        grow with ``max_len``; a ring attention layer's stops at its
        window or chunk)."""
        cache = {}
        for sfx, kind, layers in cache_groups(self.cfg):
            if kind == "ssm":
                group = ssm_mod.init_ssm_cache(self.cfg, len(layers), batch,
                                               dtype, self.device)
            else:
                group = attn_mod.init_kv_cache(self.cfg, len(layers), batch,
                                               max_len, dtype, self.device,
                                               kind=kind)
            cache.update({name + sfx: leaf for name, leaf in group.items()})
        return cache

    def init_slot_cache(self, slots: int, max_len: int,
                        dtype=torch.bfloat16) -> dict:
        """Slot-stacked cache for continuous batching: the batch axis is the
        slot axis, each slot decoding at its own position
        (`decode_slots`)."""
        return self.init_cache(slots, max_len, dtype)

    def layer_cache(self, cache: dict, i: int) -> dict:
        """Layer ``i``'s views into ``cache``, under the bare leaf names."""
        sfx, j = self._cache_at[i]
        names = ("h", "conv") if self.cfg.block_kind(i) == "ssm" else ("k", "v")
        return {n: cache[n + sfx][j] for n in names}

    # ---- forward ---------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.scale_embeddings:
            x = x * self.cfg.d_model ** 0.5
        return x

    def _trunk(self, params, x, cache, cache_pos, slots: bool = False):
        for i, lp in enumerate(params["layers"]):
            lc = None if cache is None else self.layer_cache(cache, i)
            x, _ = block_apply(self.cfg, lp, x, kind=self.cfg.block_kind(i),
                               cache=lc, cache_pos=cache_pos, slots=slots)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = norm_apply(cfg, params["final_norm"], x)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return softcap((x @ head).float(), cfg.final_softcap)

    def prefill(self, params, tokens, cache):
        """Forward that also fills the cache from position 0."""
        x = self._embed(params, tokens)
        x = self._trunk(params, x, cache, 0)
        return self._logits(params, x), cache

    def decode_step(self, params, cache, tokens, pos: int):
        """One-token decode of every batch row at write index ``pos``.
        tokens: (B, 1). Returns (logits (B, 1, vp), cache)."""
        x = self._embed(params, tokens)
        x = self._trunk(params, x, cache, int(pos))
        return self._logits(params, x), cache

    def decode_slots(self, params, cache, tokens, pos):
        """Per-slot one-token decode over an `init_slot_cache` cache:
        ``tokens`` (slots,) current token per slot, ``pos`` (slots,)
        per-slot write index — positions are ragged across slots. Each
        slot is its own MoE dispatch group, as in the reference's vmap
        (`decode_step` instead dispatches its batch as one call).
        Returns (logits (slots, vocab_padded), cache)."""
        x = self._embed(params, tokens.long()[:, None])
        x = self._trunk(params, x, cache, pos.long(), slots=True)
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ArchConfig, *, param_dtype=torch.float32,
                device=None) -> Model:
    return Model(cfg, param_dtype=param_dtype, device=device)
