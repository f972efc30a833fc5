"""Model assembly for the serving path (port of
`repro/models/transformer.py`): decoder stacks over any pattern of
attention blocks (full, sliding-window or chunked), Mamba-2 SSD blocks and
RG-LRU blocks, with a dense or Mixture-of-Experts FFN, RMSNorm or
LayerNorm, RoPE or absolute position embeddings, and an optional encoder
whose output every decoder block cross-attends (enc-dec, whisper).

Parameters are a plain dict in the reference's layout — ``embed`` (vp, d),
``lm_head`` (d, vp) unless the embeddings are tied, ``pos_embed``
(max_position, d) for attention without RoPE, ``final_norm`` and one
block dict per layer in ``layers`` (a list: a Python loop over layers
replaces ``lax.scan``; the reference's ``tail`` blocks follow its cycles),
and for an enc-dec config ``encoder`` = {``layers``: its ``attn_bidir``
blocks, ``final_norm``}. Every weight is kept ``(in, out)``.

The cache is a flat dict of leaves grouped as the reference's cache tree
groups them (`cache_groups`): one group per layer-pattern entry, stacking
that entry's layers of every full pattern cycle on a leading axis, and one
group per leftover ("tail") layer. A pattern of one entry keeps the bare
leaf names — ``{"k", "v"}`` with leaves (layers, batch, T, kvh, hd) for
attention, ``{"h", "conv"}`` for Mamba-2 ((layers, batch, nh, hp, ds) and
(layers, batch, K-1, di+2ds)) and RG-LRU ((layers, batch, di) f32 and
(layers, batch, K-1, di)); a longer pattern suffixes each name with its
group (``k.0`` … ``k.3``, ``k.t0`` for tail layer 0), since its groups may
differ in kind and ring length. An enc-dec config banks the encoder K/V
``ek``/``ev`` (layers, batch, enc_seq, kvh, hd) in every group beside its
own state: `prefill` runs the encoder once and fills the bank, decode
reads it. For continuous batching the batch axis is the slot axis, and
`decode_slots` advances every slot at its own position in one batched
step (the slot dimension written out where the reference vmaps). Caches
are updated in place.

Serving (`prefill`, `decode_step`, `decode_slots`) runs the hand-written
kernels: RMSNorm (ln1, ln2, the post-norms ln1_post/ln2_post of a
post-norm block, final_norm, the SSD gated norm) runs `kernels.rmsnorm`;
LayerNorm is plain PyTorch, as the reference's is plain jnp; prefill
self-attention and the encoder's bidirectional attention run
`kernels.flash_attention`; the SSD prefill scan runs `kernels.ssd_scan`.

The teacher-forced `forward` (the training step's, `train.steps`) takes
the plain route instead (``plain=True`` through `block_apply`): the
reference's training forward runs no Pallas kernel, and the hand kernels
are forward-only, so it computes what the reference computes in plain,
differentiable PyTorch — `common.rms_norm`, naive attention (blockwise
above `attention.FLASH_SEQ_THRESHOLD` tokens), `ssm._ssd_chunked` — and
sums the MoE load-balance loss over the layers. With ``remat`` each cycle
of ``layer_pattern`` (and each encoder layer) is recomputed in the
backward instead of stored, as the reference checkpoints its scan body.

`param_specs` and `cache_specs` give the reference's Megatron layouts of
the parameter and cache trees (`common.P` leaves, mirroring the port's
trees), for `sharding.specs` to resolve against a mesh shape.

A model built with a `common.ShardCtx` on a mesh of processes runs this
process's shards (`sharding.specs.place`): attention and the dense FFN are
rank-local (`attention.attn_apply`, `mlp.mlp_apply`), an MoE FFN expert-
parallel (`mlp.moe_apply_expert_parallel`: this rank's experts, its
share of the replica's tokens dispatched over ``model`` by all-to-all),
the embedding and
the head vocab-parallel — each rank looks up the token ids in its own
``embed`` rows, zeros for the rest, summed over ``model``; its head (the
local ``lm_head`` columns, or the local ``embed`` rows transposed for a
tied head) gives its slice of the vocabulary. `forward` returns those
local logits (the train step's vocab-parallel loss reads them);
`prefill` and `decode_step` gather them over ``model``. The batch is this
replica's rows and the cache its shard (`init_cache` makes the local
one). Norms and ``pos_embed`` are replicated.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tr
from repro_torch.configs.base import ATTN_KINDS, ArchConfig
from repro_torch.core.collectives import all_gather_units
from repro_torch.kernels import mode
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    NO_SHARD, P, KeepPart, ShapesOnly, ShardCtx, embed_init, layer_norm,
    rms_norm, sanitize_spec, softcap,
)
from repro_torch.sharding.specs import local_shape, local_shard

# the block kinds a decoder serves (the reference's serve engine's), and
# those whose state is cumulative
DECODER_KINDS = ("attn", "attn_sw", "attn_chunked", "ssm", "rglru")
RECURRENT_KINDS = ("ssm", "rglru")


# ---------------------------------------------------------------------------
# norms

def norm_init(cfg: ArchConfig, dtype, device) -> dict:
    if cfg.norm_type == "ln":
        return {"w": torch.ones(cfg.d_model, dtype=dtype, device=device),
                "b": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    # gemma-style (1+w): an RMSNorm's w starts at zero
    fill = torch.zeros if cfg.norm_type == "rms" else torch.ones
    return {"w": fill(cfg.d_model, dtype=dtype, device=device)}


def norm_specs(cfg: ArchConfig) -> dict:
    s = {"w": P(None)}
    if cfg.norm_type == "ln":
        s["b"] = P(None)
    return s


def norm_apply(cfg: ArchConfig, p: dict, x, plain: bool = False):
    if cfg.norm_type == "ln":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    if plain:
        return rms_norm(x, p["w"], cfg.norm_eps, plus_one=True)
    flat = x.reshape(-1, x.shape[-1])
    return rmsnorm(flat, p["w"], eps=cfg.norm_eps, plus_one=True).reshape(x.shape)


# ---------------------------------------------------------------------------
# blocks

def _has_ffn(cfg: ArchConfig, kind: str) -> bool:
    return cfg.d_ff > 0 and kind != "ssm"


def _moe_ffn(cfg: ArchConfig, kind: str) -> bool:
    return cfg.moe is not None and kind in ATTN_KINDS


def block_init(cfg: ArchConfig, gen: torch.Generator, dtype, kind: str, *,
               cross: bool = False) -> dict:
    dev = gen.device
    p = {"ln1": norm_init(cfg, dtype, dev)}
    if kind in ATTN_KINDS:
        p["mixer"] = attn_mod.attn_init(cfg, gen, dtype)
    elif kind == "ssm":
        p["mixer"] = ssm_mod.ssm_init(cfg, gen, dtype)
    elif kind == "rglru":
        p["mixer"] = rglru_mod.rglru_init(cfg, gen, dtype)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        p["ln1_post"] = norm_init(cfg, dtype, dev)
    if cross:
        p["ln_cross"] = norm_init(cfg, dtype, dev)
        p["cross"] = attn_mod.attn_init(cfg, gen, dtype, cross=True)
    if _has_ffn(cfg, kind):
        p["ln2"] = norm_init(cfg, dtype, dev)
        if _moe_ffn(cfg, kind):
            p["ffn"] = mlp_mod.moe_init(cfg, gen, dtype)
        else:
            p["ffn"] = mlp_mod.mlp_init(cfg, gen, dtype)
        if cfg.post_norms:
            p["ln2_post"] = norm_init(cfg, dtype, dev)
    return p


def block_specs(cfg: ArchConfig, kind: str, tp: str = "model", *,
                cross: bool = False) -> dict:
    """The Megatron layout of one block's parameters (`block_init`'s tree)."""
    s: Dict[str, Any] = {"ln1": norm_specs(cfg)}
    if kind in ATTN_KINDS:
        s["mixer"] = attn_mod.attn_specs(cfg, tp)
    elif kind == "ssm":
        s["mixer"] = ssm_mod.ssm_specs(cfg, tp)
    elif kind == "rglru":
        s["mixer"] = rglru_mod.rglru_specs(cfg, tp)
    if cfg.post_norms:
        s["ln1_post"] = norm_specs(cfg)
    if cross:
        s["ln_cross"] = norm_specs(cfg)
        s["cross"] = attn_mod.attn_specs(cfg, tp, cross=True)
    if _has_ffn(cfg, kind):
        s["ln2"] = norm_specs(cfg)
        if _moe_ffn(cfg, kind):
            s["ffn"] = mlp_mod.moe_specs(cfg, tp)
        else:
            s["ffn"] = mlp_mod.mlp_specs(cfg, tp)
        if cfg.post_norms:
            s["ln2_post"] = norm_specs(cfg)
    return s


def block_apply(cfg: ArchConfig, p: dict, x, *, kind: str,
                cache: Optional[dict], cache_pos, slots: bool = False,
                enc_out=None, plain: bool = False, positions=None,
                ctx: ShardCtx = NO_SHARD, seq_shard: bool = False):
    """Returns (x, cache, aux): ``aux`` is the MoE FFN's load-balance loss
    (0.0 for a block without one). ``slots``: ``x`` is a decode tick of one
    token a serving slot, and an MoE FFN dispatches each slot on its own
    (`mlp.moe_apply_slots`); otherwise its capacity is per call. A
    post-norm block (gemma2) normalizes the mixer's and the FFN's output
    before its residual add. An enc-dec block cross-attends after its
    mixer: over ``enc_out`` (banking its K/V into the cache's ``ek``/``ev``
    when there is a cache), or over the bank. ``plain``: the cache-less
    training route, every op plain PyTorch, attention at ``positions``.
    ``ctx``: this process's mesh (rank-local attention and dense FFN, the
    expert-parallel MoE FFN, `mlp.moe_apply_expert_parallel`, in every
    mode); ``seq_shard``: the cache holds this rank's block of its
    rows."""
    cross_cache, self_cache = None, cache
    if cache is not None and "ek" in cache:
        cross_cache = {"ek": cache["ek"], "ev": cache["ev"]}
        self_cache = {n: c for n, c in cache.items() if n not in ("ek", "ev")}
    aux = 0.0
    h = norm_apply(cfg, p["ln1"], x, plain)
    if kind in ATTN_KINDS:
        out, _ = attn_mod.attn_apply(cfg, p["mixer"], h, kind=kind,
                                     cache=self_cache, cache_pos=cache_pos,
                                     plain=plain, positions=positions,
                                     ctx=ctx, seq_shard=seq_shard)
    elif kind == "ssm":
        out, _ = ssm_mod.ssm_apply(cfg, p["mixer"], h, cache=self_cache,
                                   cache_pos=cache_pos, plain=plain)
    elif kind == "rglru":
        out, _ = rglru_mod.rglru_apply(cfg, p["mixer"], h, cache=self_cache)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        out = norm_apply(cfg, p["ln1_post"], out, plain)
    x = x + out
    if "cross" in p:
        hc = norm_apply(cfg, p["ln_cross"], x, plain)
        out, _ = attn_mod.attn_apply(cfg, p["cross"], hc, kind="attn_bidir",
                                     kv_x=enc_out, cross_cache=cross_cache)
        x = x + out
    if _has_ffn(cfg, kind):
        h2 = norm_apply(cfg, p["ln2"], x, plain)
        if not _moe_ffn(cfg, kind):
            out = mlp_mod.mlp_apply(cfg, p["ffn"], h2, ctx)
        elif ctx.mesh is not None:
            out, moe_aux = mlp_mod.moe_apply_expert_parallel(
                cfg, p["ffn"], h2, ctx, aux=plain)
            aux = moe_aux["moe_aux_loss"]
        elif slots:
            out = mlp_mod.moe_apply_slots(cfg, p["ffn"], h2)
        else:
            out, moe_aux = mlp_mod.moe_apply(cfg, p["ffn"], h2)
            aux = moe_aux["moe_aux_loss"]
        if cfg.post_norms:
            out = norm_apply(cfg, p["ln2_post"], out, plain)
        x = x + out
    return x, cache, aux


def validate_model_cfg(cfg: ArchConfig) -> None:
    """Refuse what the reference cannot serve: a decoder block kind outside
    `DECODER_KINDS` (an ``attn_bidir`` block serves only in the encoder),
    or an SSD or RG-LRU block without its spec."""
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    bad = sorted(kinds - set(DECODER_KINDS))
    if bad:
        raise ValueError(
            f"{cfg.arch_id}: the port serves decoder blocks of kinds "
            f"{DECODER_KINDS}; got {bad}"
        )
    for kind, spec in (("ssm", cfg.ssm), ("rglru", cfg.rglru)):
        if kind in kinds and spec is None:
            raise ValueError(
                f"{cfg.arch_id}: {kind!r} blocks in the pattern, but "
                f"cfg.{kind} is None"
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
    """Functional model bundle for one architecture on one device, or for
    one process of a mesh (``ctx``, on the mesh's device)."""

    def __init__(self, cfg: ArchConfig, *, param_dtype=torch.float32,
                 device=None, remat: bool = True,
                 ctx: Optional[ShardCtx] = None):
        validate_model_cfg(cfg)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.ctx = ctx or NO_SHARD
        self.device = (self.ctx.mesh.device if self.ctx.mesh is not None
                       else mode.resolve_device(device))
        self.remat = remat
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
        return self._init(generator)

    def init_shards(self, generator: torch.Generator, specs, mesh) -> dict:
        """`init`'s parameters from ``generator`` (the same draws), each
        leaf cut to this process's shard under ``specs`` (sanitized
        `param_specs`) on ``mesh`` as soon as it is drawn: the process
        never holds the whole tree, only one leaf's draw at a time (dense
        blocks only, as `param_shapes`)."""
        probe = ShapesOnly()
        shapes = self._init(probe)
        spec_of = {id(leaf): spec for leaf, spec in
                   zip(tr.leaves(shapes), tr.leaves(specs))}
        order = iter([spec_of[id(leaf)] for leaf in probe.drawn])
        kept = set()

        def cut(leaf, spec):
            part = local_shard(leaf, spec, mesh)
            part = part.clone() if part.numel() != leaf.numel() else part
            kept.add(id(part))
            return part

        params = self._init(KeepPart(generator,
                                     lambda w: cut(w, next(order))))
        return tr.tree_map(lambda x, s: x if id(x) in kept else cut(x, s),
                           params, specs)

    def param_shapes(self) -> dict:
        """`init`'s tree as empty meta tensors: the full (one-device)
        shapes and dtypes, nothing allocated. Dense blocks only (an SSD
        or RG-LRU init draws as it builds)."""
        return self._init(ShapesOnly())

    def _init(self, generator) -> dict:
        cfg, dt = self.cfg, self.param_dtype
        dev = (generator.device if isinstance(generator, ShapesOnly)
               else self.device)
        vp = cfg.padded_vocab()
        cross = cfg.encoder is not None
        params: Dict[str, Any] = {
            "embed": embed_init(generator, (vp, cfg.d_model), dt),
            "final_norm": norm_init(cfg, dt, dev),
            "layers": [block_init(cfg, generator, dt, cfg.block_kind(i),
                                  cross=cross)
                       for i in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(generator, (cfg.d_model, vp), dt)
        if _has_pos_embed(cfg):
            params["pos_embed"] = embed_init(
                generator, (cfg.max_position, cfg.d_model), dt)
        if cross:
            params["encoder"] = {
                "layers": [block_init(cfg, generator, dt, "attn_bidir")
                           for _ in range(cfg.encoder.n_layers)],
                "final_norm": norm_init(cfg, dt, dev),
            }
        return params

    def param_specs(self, tp: str = "model") -> dict:
        """The Megatron layout of `init`'s tree over the tensor-parallel
        axis ``tp``: the reference's `param_specs`, each layer's spec that
        of its stacked pattern entry less the leading cycle axis."""
        cfg = self.cfg
        cross = cfg.encoder is not None
        specs: Dict[str, Any] = {
            "embed": P(tp, None),
            "final_norm": norm_specs(cfg),
            "layers": [block_specs(cfg, cfg.block_kind(i), tp, cross=cross)
                       for i in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = P(None, tp)
        if _has_pos_embed(cfg):
            specs["pos_embed"] = P(None, None)
        if cross:
            specs["encoder"] = {
                "layers": [block_specs(cfg, "attn_bidir", tp)
                           for _ in range(cfg.encoder.n_layers)],
                "final_norm": norm_specs(cfg),
            }
        return specs

    # ---- caches ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16, specs: Optional[dict] = None,
                   device=None) -> dict:
        """Every layer's state, by `cache_groups` (an SSD or RG-LRU state
        does not grow with ``max_len``; a ring attention layer's stops at
        its window or chunk), with an enc-dec config's encoder K/V bank
        beside each group's own state. ``batch`` is the global batch; with
        ``specs`` (`cache_specs` on the model's mesh) each leaf is this
        process's shard of it. ``device`` overrides the model's (``meta``
        for shapes only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        if specs is not None:
            full = self.init_cache(batch, max_len, dtype, device="meta")
            return {n: torch.zeros(local_shape(leaf.shape, specs[n],
                                               self.ctx.mesh),
                                   dtype=dtype, device=dev)
                    for n, leaf in full.items()}
        cache = {}
        for sfx, kind, layers in cache_groups(cfg):
            n = len(layers)
            if kind == "ssm":
                group = ssm_mod.init_ssm_cache(cfg, n, batch, dtype, dev)
            elif kind == "rglru":
                group = rglru_mod.init_rglru_cache(cfg, n, batch, dtype, dev)
            else:
                group = attn_mod.init_kv_cache(cfg, n, batch, max_len, dtype,
                                               dev, kind=kind)
            if cfg.encoder is not None:
                group.update(attn_mod.init_cross_kv_cache(cfg, n, batch,
                                                          dtype, dev))
            cache.update({name + sfx: leaf for name, leaf in group.items()})
        return cache

    def cache_specs(self, cache: dict, mesh_shape: Optional[dict] = None,
                    dp: Tuple[str, ...] = ("data",),
                    tp: str = "model") -> dict:
        """The reference's cache layout, per leaf of `init_cache`'s dict
        (every leaf carries the leading layer-group axis, replicated): the
        batch over the ``dp`` axes when it divides, else — K/V only — the
        sequence over ``dp`` and ``tp`` (context-parallel long decode);
        K/V heads, the conv channels and the state heads over ``tp``;
        sanitized against ``mesh_shape``. Without a mesh every leaf is
        replicated (``P()``)."""
        if mesh_shape is None:
            return {name: P() for name in cache}
        dp = tuple(dp)
        dp_size = 1
        for a in dp:
            dp_size *= mesh_shape[a]

        def spec_for(name, leaf):
            kind = name.split(".")[0]
            b_axis = dp if leaf.shape[1] % dp_size == 0 else None
            if kind in ("k", "v", "ek", "ev"):
                if b_axis is not None:
                    return P(None, b_axis, tp, None, None)
                return P(None, None, dp + (tp,), None, None)
            if kind == "conv":
                return P(None, b_axis, None, tp)
            if kind == "h":
                return P(None, b_axis, tp, *(None,) * (leaf.ndim - 3))
            return P(*(None,) * leaf.ndim)

        return {name: sanitize_spec(mesh_shape, leaf.shape,
                                    spec_for(name, leaf))
                for name, leaf in cache.items()}

    def init_slot_cache(self, slots: int, max_len: int,
                        dtype=torch.bfloat16) -> dict:
        """Slot-stacked cache for continuous batching: the batch axis is the
        slot axis, each slot decoding at its own position
        (`decode_slots`)."""
        return self.init_cache(slots, max_len, dtype)

    def _seq_split(self, cache, specs: Optional[dict]) -> frozenset:
        """The cache groups (leaf-name suffixes) whose K/V rows ``specs``
        (`cache_specs` on the model's mesh) split over ``model``; none on
        one device or without a cache."""
        if self.ctx.mesh is None or cache is None:
            return frozenset()
        if specs is None:
            raise ValueError("on a mesh, prefill and decode take the "
                             "cache's specs (cache_specs on the mesh)")
        return frozenset(name[1:] for name, spec in specs.items()
                         if name.split(".")[0] == "k"
                         and tuple(spec)[2] is not None)

    def layer_cache(self, cache: dict, i: int) -> dict:
        """Layer ``i``'s views into ``cache``, under the bare leaf names."""
        sfx, j = self._cache_at[i]
        names = (("h", "conv") if self.cfg.block_kind(i) in RECURRENT_KINDS
                 else ("k", "v"))
        if self.cfg.encoder is not None:
            names += ("ek", "ev")
        return {n: cache[n + sfx][j] for n in names}

    # ---- forward ---------------------------------------------------------
    def _embed(self, params, tokens, positions=None):
        """Token embeddings (B, S, d), plus ``pos_embed`` at ``positions``
        (an int for a one-token step, (S,) shared by the batch, or (B, S);
        0..S-1 when None) where the config has it."""
        emb = params["embed"]
        rows = emb.shape[0]
        if self.ctx.mesh is not None and rows != self.cfg.padded_vocab():
            # vocab-parallel: this rank's rows, zeros for the others' ids
            ids = tokens - self.ctx.rank * rows
            own = (ids >= 0) & (ids < rows)
            x = torch.where(own[..., None], emb[ids.clamp(0, rows - 1)],
                            torch.zeros((), dtype=emb.dtype,
                                        device=emb.device))
            x = self.ctx.exit(x)
        else:
            x = emb[tokens]
        if self.cfg.scale_embeddings:
            x = x * self.cfg.d_model ** 0.5
        if "pos_embed" in params:
            if positions is None:
                positions = torch.arange(tokens.shape[1],
                                         device=tokens.device)
            x = x + params["pos_embed"][positions]
        return x

    def _encode(self, params, enc_input, plain: bool = False):
        """The encoder over ``enc_input`` (B, enc_seq, d) frame embeddings:
        its ``attn_bidir`` blocks (no cache), then its final norm.
        ``plain``: the training route, each layer recomputed in the
        backward when ``remat``."""
        x = enc_input
        layers = params["encoder"]["layers"]
        for i in range(len(layers)):
            x, _ = self._blocks(layers, x, i, i + 1, kinds=("attn_bidir",),
                                plain=plain, remat=plain and self.remat)
        return norm_apply(self.cfg, params["encoder"]["final_norm"], x, plain)

    def _blocks(self, layers, x, i0: int, i1: int, *, kinds, plain: bool,
                remat: bool, positions=None, enc_out=None):
        """Blocks ``i0`` .. ``i1 - 1`` of ``layers`` (kinds cycling through
        ``kinds``) on the cache-less route, checkpointed as one unit when
        ``remat``. Returns (x, their summed MoE aux loss)."""
        def run(x):
            aux = 0.0
            for i in range(i0, i1):
                x, _, a = block_apply(
                    self.cfg, layers[i], x, kind=kinds[i % len(kinds)],
                    cache=None, cache_pos=None, enc_out=enc_out, plain=plain,
                    positions=positions, ctx=self.ctx)
                aux = aux + a
            return x, aux

        if remat:
            return checkpoint(run, x, use_reentrant=False)
        return run(x)

    def _trunk(self, params, x, cache, cache_pos, slots: bool = False,
               enc_out=None, specs: Optional[dict] = None):
        split = self._seq_split(cache, specs)
        for i, lp in enumerate(params["layers"]):
            lc = None if cache is None else self.layer_cache(cache, i)
            x, _, _ = block_apply(self.cfg, lp, x,
                                  kind=self.cfg.block_kind(i), cache=lc,
                                  cache_pos=cache_pos, slots=slots,
                                  enc_out=enc_out, ctx=self.ctx,
                                  seq_shard=self._cache_at[i][0] in split)
        return x

    def _logits(self, params, x, plain: bool = False):
        """Logits (B, S, vp) f32; on a mesh this rank's vocabulary slice
        (B, S, vp / n_model)."""
        cfg = self.cfg
        x = norm_apply(cfg, params["final_norm"], x, plain)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        if head.shape[1] != cfg.padded_vocab():
            x = self.ctx.enter(x)
        return softcap((x @ head).float(), cfg.final_softcap)

    def _gathered(self, logits):
        """Local vocabulary slices gathered over ``model`` (no-op on one
        device or a replicated head)."""
        if self.ctx.mesh is None or logits.shape[-1] == self.cfg.padded_vocab():
            return logits
        parts = all_gather_units(logits, self.ctx.mesh.model)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    def forward(self, params, tokens, *, enc_input=None, positions=None):
        """Teacher-forced forward on the plain route (differentiable on
        every device; no kernel runs). tokens: (B, S); ``positions`` (S,)
        default 0..S-1. Returns (logits (B, S, vp) f32, {"moe_aux_loss":
        the MoE load-balance loss summed over the layers, f32 scalar}).
        With ``remat`` each full cycle of ``layer_pattern`` is recomputed
        in the backward; the leftover ("tail") layers are not, as in the
        reference."""
        cfg = self.cfg
        tokens = tokens.long()
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        enc_out = None
        if cfg.encoder is not None:
            if enc_input is None:
                raise ValueError(
                    f"{cfg.arch_id} is enc-dec: forward needs enc_input")
            enc_out = self._encode(params, enc_input, plain=True)
        x = self._embed(params, tokens, positions)
        pat, layers = len(cfg.layer_pattern), params["layers"]
        n_cyc = cfg.n_layers // pat
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # the full cycles (each remat as one unit), then the tail (never)
        for i0, i1, remat in [(c, c + pat, self.remat)
                              for c in range(0, n_cyc * pat, pat)] \
                + [(n_cyc * pat, cfg.n_layers, False)]:
            x, a = self._blocks(layers, x, i0, i1, kinds=cfg.layer_pattern,
                                plain=True, remat=remat, positions=positions,
                                enc_out=enc_out)
            aux = aux + a
        return self._logits(params, x, plain=True), {"moe_aux_loss": aux}

    def prefill(self, params, tokens, cache, *, enc_input=None,
                specs: Optional[dict] = None):
        """Forward that also fills the cache from position 0; an enc-dec
        config encodes ``enc_input`` (B, enc_seq, d) once and banks every
        decoder layer's cross K/V in the cache. On a mesh ``specs`` is the
        cache's layout (`cache_specs`), as `init_cache` placed it."""
        enc_out = None
        if self.cfg.encoder is not None:
            if enc_input is None:
                raise ValueError(
                    f"{self.cfg.arch_id} is enc-dec: prefill needs enc_input")
            enc_out = self._encode(params, enc_input)
        x = self._embed(params, tokens)
        x = self._trunk(params, x, cache, 0, enc_out=enc_out, specs=specs)
        return self._gathered(self._logits(params, x)), cache

    def decode_step(self, params, cache, tokens, pos: int, *,
                    specs: Optional[dict] = None):
        """One-token decode of every batch row at write index ``pos``
        (cross-attention reads the encoder bank). tokens: (B, 1). Returns
        (logits (B, 1, vp), cache). ``specs``: as `prefill`'s."""
        pos = int(pos)
        x = self._embed(params, tokens, pos)
        x = self._trunk(params, x, cache, pos, specs=specs)
        return self._gathered(self._logits(params, x)), cache

    def decode_slots(self, params, cache, tokens, pos):
        """Per-slot one-token decode over an `init_slot_cache` cache:
        ``tokens`` (slots,) current token per slot, ``pos`` (slots,)
        per-slot write index — positions are ragged across slots. Each
        slot is its own MoE dispatch group, as in the reference's vmap
        (`decode_step` instead dispatches its batch as one call).
        Returns (logits (slots, vocab_padded), cache)."""
        pos = pos.long()
        x = self._embed(params, tokens.long()[:, None], pos[:, None])
        x = self._trunk(params, x, cache, pos, slots=True)
        return self._logits(params, x)[:, 0], cache


def _has_pos_embed(cfg: ArchConfig) -> bool:
    """Absolute position embeddings: attention blocks without RoPE."""
    return not cfg.use_rope and any(k in ATTN_KINDS for k in cfg.layer_pattern)


def build_model(cfg: ArchConfig, *, param_dtype=torch.float32,
                device=None, remat: bool = True,
                ctx: Optional[ShardCtx] = None) -> Model:
    return Model(cfg, param_dtype=param_dtype, device=device, remat=remat,
                 ctx=ctx)
