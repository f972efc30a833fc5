"""Model assembly for the serving path: decoder-only stacks of
full-attention blocks with a dense MLP, or of Mamba-2 SSD blocks (port of
`repro/models/transformer.py`).

Parameters are a plain dict in the reference's layout — ``embed`` (vp, d),
``lm_head`` (d, vp) unless the embeddings are tied, ``final_norm.w`` and one
block dict per layer in ``layers`` (a list: a Python loop over layers
replaces ``lax.scan``), with every weight kept ``(in, out)``. The cache
stacks every layer's state on a leading layer axis: ``{"k", "v"}`` with
leaves (layers, batch, T, kvh, hd) for attention, ``{"h", "conv"}`` with
leaves (layers, batch, nh, hp, ds) and (layers, batch, K-1, di+2ds) for
Mamba-2. For continuous batching the batch axis is the slot axis, and
`decode_slots` advances every slot at its own position in one batched step
(the slot dimension written out where the reference vmaps). Caches are
updated in place.

RMSNorm (ln1, ln2, final_norm, the SSD gated norm) runs the hand-written
`kernels.rmsnorm`; prefill attention runs `kernels.flash_attention`; the
SSD prefill scan runs `kernels.ssd_scan`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
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


def block_init(cfg: ArchConfig, gen: torch.Generator, dtype,
               kind: str) -> dict:
    p = {"ln1": norm_init(cfg, dtype, gen.device)}
    if kind == "ssm":
        p["mixer"] = ssm_mod.ssm_init(cfg, gen, dtype)
    else:
        p["mixer"] = attn_mod.attn_init(cfg, gen, dtype)
    if _has_ffn(cfg, kind):
        p["ln2"] = norm_init(cfg, dtype, gen.device)
        p["ffn"] = mlp_mod.mlp_init(cfg, gen, dtype)
    return p


def block_apply(cfg: ArchConfig, p: dict, x, *, kind: str,
                cache: Optional[dict], cache_pos):
    """Returns (x, cache)."""
    h = norm_apply(cfg, p["ln1"], x)
    if kind == "ssm":
        out, cache = ssm_mod.ssm_apply(cfg, p["mixer"], h, cache=cache,
                                       cache_pos=cache_pos)
    else:
        out, cache = attn_mod.attn_apply(
            cfg, p["mixer"], h, kind=kind, cache=cache, cache_pos=cache_pos,
        )
    x = x + out
    if _has_ffn(cfg, kind):
        h2 = norm_apply(cfg, p["ln2"], x)
        x = x + mlp_mod.mlp_apply(cfg, p["ffn"], h2)
    return x, cache


def validate_model_cfg(cfg: ArchConfig) -> None:
    """The blocks the port runs so far: full causal self-attention with
    RoPE and a dense FFN, or Mamba-2 SSD blocks (no FFN, no RoPE), with
    RMSNorm. Other archs wait for their slices."""
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    attn = kinds == {"attn"} and cfg.d_ff > 0 and cfg.use_rope
    ssm = (kinds == {"ssm"} and cfg.ssm is not None and cfg.d_ff == 0
           and not cfg.use_rope)
    if (not (attn or ssm) or cfg.moe is not None or cfg.encoder is not None
            or cfg.norm_type != "rms" or cfg.post_norms):
        raise ValueError(
            f"{cfg.arch_id}: the port serves full-attention decoders with a "
            f"dense FFN and RoPE, and Mamba-2 SSD stacks (d_ff=0, no RoPE), "
            f"with RMSNorm, so far; got kinds {sorted(kinds)}, "
            f"moe={cfg.moe is not None}, encoder={cfg.encoder is not None}, "
            f"d_ff={cfg.d_ff}, use_rope={cfg.use_rope}, "
            f"norm_type={cfg.norm_type!r}, post_norms={cfg.post_norms}"
        )


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
        """Every layer's state, stacked on a leading layer axis (an SSD
        state does not grow with ``max_len``)."""
        if "ssm" in self.cfg.layer_pattern:     # all-SSD (validated)
            return ssm_mod.init_ssm_cache(self.cfg, self.cfg.n_layers, batch,
                                          dtype, self.device)
        return attn_mod.init_kv_cache(self.cfg, self.cfg.n_layers, batch,
                                      max_len, dtype, self.device)

    def init_slot_cache(self, slots: int, max_len: int,
                        dtype=torch.bfloat16) -> dict:
        """Slot-stacked cache for continuous batching: the batch axis is the
        slot axis, each slot decoding at its own position
        (`decode_slots`)."""
        return self.init_cache(slots, max_len, dtype)

    # ---- forward ---------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.scale_embeddings:
            x = x * self.cfg.d_model ** 0.5
        return x

    def _trunk(self, params, x, cache, cache_pos):
        for i, lp in enumerate(params["layers"]):
            lc = None if cache is None else {n: leaf[i]
                                             for n, leaf in cache.items()}
            x, _ = block_apply(self.cfg, lp, x, kind=self.cfg.block_kind(i),
                               cache=lc, cache_pos=cache_pos)
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
        per-slot write index — positions are ragged across slots.
        Returns (logits (slots, vocab_padded), cache)."""
        x = self._embed(params, tokens.long()[:, None])
        x = self._trunk(params, x, cache, pos.long())
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ArchConfig, *, param_dtype=torch.float32,
                device=None) -> Model:
    return Model(cfg, param_dtype=param_dtype, device=device)
