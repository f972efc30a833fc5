"""Self- and cross-attention with GQA, RoPE (where ``cfg.use_rope``), QKV
bias, qk-norm, logit softcap and a slot-addressed KV cache (port of
`repro/models/attention.py`).

Prefill (S > 1) attends the fresh K/V through the hand-written flash
kernel (`kernels.flash_attention`), which computes exactly the reference's
`_attend_naive` under `_mask_bias`. Decode (S == 1) stays plain PyTorch
`_attend_naive` over the cache, as in the reference (a 1×T score row per
head). In decode every batch row carries its own write position, so one
call advances a whole pool of serving slots at ragged positions — the
slot dimension written out where the reference vmaps.

Sliding-window (``attn_sw``) and chunked (``attn_chunked``) layers keep a
ring cache of ``min(max_len, window)`` / ``min(max_len, chunk_size)`` rows
(`init_kv_cache`): position ``p`` lives in row ``p % w``; a prefill longer
than the ring keeps only its tail (it attends its own fresh K/V, so early
queries still see their whole window), and decode reads row ``i`` as
absolute position ``last − ((last − i) mod w)``, masking rows not yet
written. Full attention keeps a full-length cache.

An encoder's ``attn_bidir`` blocks run the flash kernel with its bidir
mask. The training forward takes the plain route instead (``plain=True``):
the reference's `_attend_naive` under `_mask_bias` up to
``FLASH_SEQ_THRESHOLD`` (8192) tokens and its blockwise online softmax
(`_attend_blockwise`, blocks of 512 queries and 1024 keys) above, in
plain, differentiable PyTorch (the flash kernel is forward-only).
Cross-attention (enc-dec decoders) attends the encoder output
bidirectionally and naively, as the reference does: at prefill it
computes the encoder K/V and banks them (``ek``/``ev``,
`init_cross_kv_cache`), and decode reads the bank.

On a mesh of processes (``ctx``, `models.common.ShardCtx`) attention is
rank-local, Megatron's column/row split: ``wq``/``bq`` hold this rank's
query heads ``[rank·H/n, (rank+1)·H/n)`` and ``wo`` their rows, so the
output is a partial sum, reduced over ``model`` (`ShardCtx.exit`). The
replicated ``wk``/``wv`` (and ``bk``/``bv``, ``q_norm``/``k_norm``) enter
the region through `ShardCtx.enter`, so their gradients are summed over
``model``: without a cache each rank computes only the KV heads its query
heads map to (`local_heads`). The cache holds every KV head, as the
reference lays it out: this replica's batch rows and, where the model
axis divides its length, this rank's block of its rows (``seq_shard``).
Prefill then writes the rows of its block and attends its own heads'
fresh K/V; a decode token's heads are gathered over ``model`` (where they
are split), attended over the rank's rows and the online-softmax partials
combined over ``model`` (`_attend_seq_sharded`). Masks and softcaps are
per head. Where ``n_model`` does not divide H·hd the attention weights
stay replicated: every rank computes every head, and only a split cache
is combined over ``model``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import all_gather_units, pmax_, psum_
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (
    NO_SHARD, P, ShardCtx, apply_rope, dense_init, rms_norm, softcap,
)

NEG_INF = -2.0e38  # fp32-safe mask value
# the plain route (`attn_apply(plain=True)`, the training forward) attends
# naively up to this many tokens and blockwise, in blocks of FLASH_BLOCK_Q
# queries and FLASH_BLOCK_K keys, above it, as the reference does
FLASH_SEQ_THRESHOLD = 8192
FLASH_BLOCK_Q = 512
FLASH_BLOCK_K = 1024
INT32_MAX = 2 ** 31 - 1
FLASH_KIND = {"attn": "causal", "attn_sw": "sliding",
              "attn_chunked": "chunked", "attn_bidir": "bidir"}
RING_KINDS = ("attn_sw", "attn_chunked")


# ---------------------------------------------------------------------------
# params

def attn_init(cfg: ArchConfig, gen: torch.Generator, dtype, *,
              cross: bool = False) -> dict:
    d, nh, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, nh * hd), d, dtype),
        "wk": dense_init(gen, (d, kvh * hd), d, dtype),
        "wv": dense_init(gen, (d, kvh * hd), d, dtype),
        "wo": dense_init(gen, (nh * hd, d), nh * hd, dtype),
    }
    if cfg.attn_bias and not cross:
        p["bq"] = torch.zeros(nh * hd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(kvh * hd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(kvh * hd, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=dev)
    return p


def attn_specs(cfg: ArchConfig, tp: str = "model", *, cross: bool = False) -> dict:
    s = {
        "wq": P(None, tp),
        "wk": P(None, None),  # kv_heads < TP: replicated (Megatron GQA)
        "wv": P(None, None),
        "wo": P(tp, None),
    }
    if cfg.attn_bias and not cross:
        s.update(bq=P(tp), bk=P(None), bv=P(None))
    if cfg.qk_norm:
        s.update(q_norm=P(None), k_norm=P(None))
    return s


def local_heads(cfg: ArchConfig, n_model: int, rank: int):
    """(query heads, first KV head, KV heads) of ``rank`` when the query
    heads split ``n_model`` ways: the rank's query heads are a contiguous
    block and the KV heads they map to (query head h reads KV head
    h // (H / KVH)) must be too, each read by as many of its heads. Raises
    ValueError for a layout that splits a head or groups unevenly."""
    nh, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if nh % n_model:
        raise ValueError(
            f"{cfg.arch_id}: n_heads·head_dim = {nh * hd} divides by "
            f"n_model = {n_model} but n_heads = {nh} does not: the "
            "sanitized spec splits a head across ranks (GSPMD splits it; "
            "rank-local heads cannot; ROADMAP Queue 1, 7g: split heads)")
    nh_l, g = nh // n_model, nh // kvh
    if g % nh_l and nh_l % g:
        raise ValueError(
            f"{cfg.arch_id}: {nh_l} query heads a rank do not group evenly "
            f"over KV heads of {g} query heads each")
    kv0 = rank * nh_l // g
    return nh_l, kv0, max(1, nh_l // g)


def _rank_local(cfg: ArchConfig, p: dict, ctx: ShardCtx, cached: bool):
    """This rank's view of attention params ``p`` (``wq``/``bq``/``wo``
    already its shards): the replicated leaves entered into the region and
    cut to the KV heads computed here — the rank's own, or all of them
    when they go to a cache (which holds every KV head). Returns (params,
    query heads, KV heads computed, slice of those attended or None when
    all are)."""
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    nh_l, kv0, kvh_l = local_heads(cfg, ctx.n_model, ctx.rank)
    c0, cn = (0, kvh) if cached else (kv0, kvh_l)
    local = {k: (ctx.enter(v) if k in ("q_norm", "k_norm") else v)
             for k, v in p.items()}
    for name in ("wk", "wv"):
        local[name] = ctx.enter(p[name])[:, c0 * hd:(c0 + cn) * hd]
    for name in ("bk", "bv"):
        if name in p:
            local[name] = ctx.enter(p[name])[c0 * hd:(c0 + cn) * hd]
    att = None if cn == kvh_l else slice(kv0 - c0, kv0 - c0 + kvh_l)
    return local, nh_l, cn, att


# ---------------------------------------------------------------------------
# masks

def _mask_bias(kind: str, q_pos, k_pos, window: int, chunk: int):
    """Additive mask bias (..., Sq, Sk) from position vectors."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if kind == "attn_bidir":
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                        dtype=torch.bool, device=q.device)
    else:
        ok = k <= q
        if kind == "attn_sw":
            ok &= k > q - window
        elif kind == "attn_chunked":
            ok &= (k // chunk) == (q // chunk)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return torch.where(ok, zero, NEG_INF)


# ---------------------------------------------------------------------------
# cores

def _group(q, kvh):
    """(B,S,nh,hd) -> (B,kvh,qpk,S,hd)."""
    b, s, nh, hd = q.shape
    return q.reshape(b, s, kvh, nh // kvh, hd).permute(0, 2, 3, 1, 4)


def _attend_naive(q, k, v, bias, cap: Optional[float]):
    """q: (B,kvh,g,Sq,hd); k/v: (B,Sk,kvh,hd); bias: broadcastable (...,Sq,Sk)."""
    hd = q.shape[-1]
    scores = torch.einsum("bkgqh,bskh->bkgqs", q.float(), k.float()) * (hd ** -0.5)
    scores = softcap(scores, cap) + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bkgqh", probs, v.float())


def _attend_blockwise(q, k, v, q_pos, k_pos, kind, window, chunk, cap):
    """The reference's blockwise `_attend_flash` in plain PyTorch: an online
    softmax over K/V blocks of FLASH_BLOCK_K keys for each block of
    FLASH_BLOCK_Q queries, each query block recomputed in the backward
    (checkpointed) instead of stored.

    q: (B,kvh,g,Sq,hd); k/v: (B,Sk,kvh,hd); returns (B,kvh,g,Sq,hd) f32."""
    b, kvh, g, sq, hd = q.shape
    sk = k.shape[1]
    bq, bk = min(FLASH_BLOCK_Q, sq), min(FLASH_BLOCK_K, sk)
    if sq % bq or sk % bk:
        raise ValueError(
            f"blockwise attention: sequence lengths ({sq}, {sk}) are not "
            f"multiples of the blocks ({bq}, {bk})")
    nq, nk = sq // bq, sk // bk
    ks = k.reshape(b, nk, bk, kvh, hd).permute(1, 0, 3, 2, 4)  # (nk,B,kvh,bk,hd)
    vs = v.reshape(b, nk, bk, kvh, hd).permute(1, 0, 3, 2, 4)
    kps = k_pos.reshape(nk, bk)
    qs = q.reshape(b, kvh, g, nq, bq, hd).permute(3, 0, 1, 2, 4, 5) \
        * hd ** -0.5
    qps = q_pos.reshape(nq, bq)

    def q_block(qi, qp):
        f32 = dict(dtype=torch.float32, device=q.device)
        m = torch.full((b, kvh, g, bq), NEG_INF, **f32)
        l = torch.zeros((b, kvh, g, bq), **f32)
        acc = torch.zeros((b, kvh, g, bq, hd), **f32)
        for j in range(nk):
            s = torch.einsum("bkgqh,bksh->bkgqs", qi.float(), ks[j].float())
            s = softcap(s, cap) + _mask_bias(kind, qp, kps[j], window, chunk)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p, vs[j].float())
            m = m_new
        return acc / torch.clamp(l, min=1e-38)[..., None]

    out = torch.stack([checkpoint(q_block, qs[i], qps[i], use_reentrant=False)
                       for i in range(nq)])                # (nq,B,kvh,g,bq,hd)
    return out.permute(1, 2, 3, 0, 4, 5).reshape(b, kvh, g, sq, hd)


# ---------------------------------------------------------------------------
# public apply

def attn_apply(
    cfg: ArchConfig,
    p: dict,
    x,
    *,
    kind: str,
    cache: Optional[dict] = None,   # {'k','v'} (B, T, kvh, hd), written in place
    cache_pos=None,       # prefill: int write offset; decode: int or (B,)
    kv_x=None,            # cross-attention source (B, T_enc, d); None = self
    cross_cache: Optional[dict] = None,  # {'ek','ev'} (B, T_enc, kvh, hd)
    plain: bool = False,  # the training route: plain ops, no cache
    positions=None,       # plain route: (S,) query positions (0..S-1)
    ctx: ShardCtx = NO_SHARD,
    seq_shard: bool = False,  # on a mesh: the cache's rows split over model
):
    """Returns (out, cache). The cache-less forward and prefill (S > 1)
    run at positions 0..S-1; a one-token step against a cache runs each
    row at its write position ``cache_pos``. RoPE applies iff
    ``cfg.use_rope``.

    ``plain`` is the cache-less training forward in plain, differentiable
    PyTorch, as the reference's forward computes it: the queries at
    ``positions`` (0..S-1 when None) against keys at 0..S-1, `_attend_naive`
    up to FLASH_SEQ_THRESHOLD tokens and `_attend_blockwise` above.

    Cross-attention (``kv_x`` or ``cross_cache`` given) attends the
    encoder K/V bidirectionally, naively, as the reference does: with
    ``kv_x`` its K/V are computed (and banked into ``cross_cache`` when
    one is given, the prefill); without, they are read from the bank (the
    decode). Returns (out, cross_cache) then.

    On a mesh (``ctx``) the query heads are this rank's and the output is
    reduced over ``model`` (see the module docstring); ``seq_shard``: the
    cache holds this rank's block of its rows (the reference's cache
    layout splits the sequence over ``model``)."""
    nh, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    if kv_x is not None or cross_cache is not None:
        return _cross_apply(cfg, p, x, kv_x, cross_cache)
    split = ctx.mesh is not None and p["wq"].shape[1] != nh * hd
    att = None
    if split:
        p, nh, kvh, att = _rank_local(cfg, p, ctx, cache is not None)
        x = ctx.enter(x)

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k, v = k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    decode = cache is not None and s == 1
    if decode:
        cache_pos = torch.as_tensor(cache_pos, device=x.device).expand(b)
        positions = cache_pos[:, None]                       # (B, 1)
    elif positions is None or not plain:
        positions = torch.arange(s, device=x.device)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    ka, va = (k, v) if att is None else (k[:, :, att], v[:, :, att])
    if plain:
        k, v = ka, va
        kvh = k.shape[2]
        k_pos = torch.arange(s, device=x.device)
        qg = _group(q, kvh)
        if s > FLASH_SEQ_THRESHOLD:
            out = _attend_blockwise(qg, k, v, positions, k_pos, kind,
                                    cfg.window, cfg.chunk_size,
                                    cfg.attn_softcap)
        else:
            bias = _mask_bias(kind, positions, k_pos, cfg.window,
                              cfg.chunk_size)
            out = _attend_naive(qg, k, v, bias, cfg.attn_softcap)
        out = out.permute(0, 3, 1, 2, 4)                     # (B,S,kvh,g,hd)
    elif not decode:
        if cache is not None:
            _write_prefill(cache, k, v, cache_pos, kind in RING_KINDS,
                           (ctx.rank, ctx.n_model) if seq_shard else None)
        # (B,H,S,hd) / (B,KVH,S,hd): GQA resolved inside the kernel
        out = flash_attention(
            q.transpose(1, 2).contiguous(), ka.transpose(1, 2).contiguous(),
            va.transpose(1, 2).contiguous(), kind=FLASH_KIND[kind],
            window=cfg.window, chunk=cfg.chunk_size, softcap=cfg.attn_softcap,
        ).transpose(1, 2)
    else:
        w = cache["k"].shape[1]
        lo = 0
        if seq_shard:       # this rank's rows [lo, lo + w) of the ring/cache
            lo, w = ctx.rank * w, w * ctx.n_model
        ring = kind in RING_KINDS
        rows = torch.arange(b, device=x.device)
        row = cache_pos % w if ring else cache_pos
        if seq_shard:
            _write_owned(cache, rows, row - lo, k[:, 0], v[:, 0])
        else:
            cache["k"][rows, row] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, row] = v[:, 0].to(cache["v"].dtype)
        slot = lo + torch.arange(cache["k"].shape[1], device=x.device)[None, :]
        last = cache_pos[:, None]
        if ring:    # row i holds the latest position ≡ i (mod w), if any
            k_pos = last - (last - slot) % w
            k_posm = torch.where(k_pos >= 0, k_pos, INT32_MAX)
        else:
            k_posm = torch.where(slot <= last, slot, INT32_MAX)  # (B, T)
        bias = _mask_bias(kind, positions, k_posm, cfg.window, cfg.chunk_size)
        if seq_shard:
            out = _attend_seq_sharded(cfg, q, cache, bias, ctx, split)
        else:
            ck, cv = ((cache["k"], cache["v"]) if att is None
                      else (cache["k"][:, :, att], cache["v"][:, :, att]))
            out = _attend_naive(_group(q, ck.shape[2]), ck, cv,
                                bias[:, None, None], cfg.attn_softcap)
            out = out.permute(0, 3, 1, 2, 4)                 # (B,S,kvh,g,hd)

    out = out.reshape(b, s, nh * hd).to(x.dtype)
    out = out @ p["wo"]
    return (ctx.exit(out) if split else out), cache


def _cross_apply(cfg: ArchConfig, p: dict, x, kv_x, cross_cache):
    """Cross-attention of ``x`` (B, S, d) over the encoder output ``kv_x``
    (B, T_enc, d) or, without it, over the bank ``cross_cache``; no RoPE,
    no mask."""
    nh, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, nh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if kv_x is None:
        # decode against the bank: computed (and qk-normed) once at prefill
        k, v = cross_cache["ek"], cross_cache["ev"]
    else:
        t = kv_x.shape[1]
        k = (kv_x @ p["wk"]).reshape(b, t, kvh, hd)
        v = (kv_x @ p["wv"]).reshape(b, t, kvh, hd)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cross_cache is not None:
            cross_cache["ek"].copy_(k)
            cross_cache["ev"].copy_(v)
    out = _attend_naive(_group(q, kvh), k, v, 0.0, cfg.attn_softcap)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd).to(x.dtype)
    return out @ p["wo"], cross_cache


def _write_prefill(cache: dict, k, v, cache_pos: int, ring: bool,
                   part=None) -> None:
    """Write a prefill's K/V (B, S, kvh, hd) from position ``cache_pos``:
    rows ``p % w`` of a ring (only the last ``w`` positions when S > w),
    the slice ``[cache_pos, cache_pos + S)`` of a full-length cache.
    ``part`` = (rank, n): ``cache`` holds block ``rank`` of ``n`` of the
    rows, and only the rows in it are written."""
    w, s = cache["k"].shape[1], k.shape[1]
    wl = w                       # the rows this cache holds
    if part is not None:
        lo, w = part[0] * wl, wl * part[1]
    if s > w:
        k, v, cache_pos, s = k[:, -w:], v[:, -w:], cache_pos + s - w, w
    if part is not None:
        rows = cache_pos + torch.arange(s)
        rows = rows % w if ring else rows
        # the rows and their positions picked on the host: a device mask
        # would need its nonzero count read back (and none on meta)
        src = torch.nonzero((rows >= lo) & (rows < lo + wl))[:, 0]
        dst, src = (rows[src] - lo).to(k.device), src.to(k.device)
        cache["k"][:, dst] = k[:, src].to(cache["k"].dtype)
        cache["v"][:, dst] = v[:, src].to(cache["v"].dtype)
        return
    if ring:
        rows = (cache_pos + torch.arange(s, device=k.device)) % w
    else:
        rows = slice(cache_pos, cache_pos + s)
    cache["k"][:, rows] = k.to(cache["k"].dtype)
    cache["v"][:, rows] = v.to(cache["v"].dtype)


def _write_owned(cache: dict, rows, local, k, v) -> None:
    """A decode step's K/V (B, kvh, hd) into row ``local`` (B,) of each
    batch row's block, where that row lies in the block (0 <= local < the
    block's rows); no host sync."""
    w = cache["k"].shape[1]
    own = ((local >= 0) & (local < w))[:, None, None]
    at = local.clamp(0, w - 1)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c[rows, at] = torch.where(own, new.to(c.dtype), c[rows, at])


def _attend_seq_sharded(cfg: ArchConfig, q, cache: dict, bias, ctx,
                        split: bool):
    """One decode token's attention over a cache whose rows are split over
    ``model`` (the reference's layout): every head attended over this
    rank's rows (an online-softmax partial: max, sum and weighted values)
    and the partials combined over ``model`` (the max, then the rescaled
    sums). With ``split`` the ranks' query heads are gathered first and
    this rank's heads kept after; otherwise ``q`` already holds every head.
    q: (B, 1, H/n or H, hd); bias (B, 1, rows); returns (B, 1, kvh', g',
    hd) over the heads of ``q``, as `_attend_naive` permuted."""
    b, s, nh_l, hd = q.shape
    q_all = q
    if split:
        parts = all_gather_units(q, ctx.mesh.model)    # (n, B, 1, H/n, hd)
        q_all = parts.permute(1, 2, 0, 3, 4).reshape(b, s, -1, hd)
    qg = _group(q_all, cfg.n_kv_heads)                 # (B, kvh, g, 1, hd)
    scores = torch.einsum("bkgqh,bskh->bkgqs", qg.float(),
                          cache["k"].float()) * (hd ** -0.5)
    scores = softcap(scores, cfg.attn_softcap) + bias[:, None, None]
    m = scores.amax(-1)
    e = torch.exp(scores - m[..., None])
    part = torch.cat([torch.einsum("bkgqs,bskh->bkgqh", e,
                                   cache["v"].float()),
                      e.sum(-1)[..., None]], dim=-1)   # (B, kvh, g, 1, hd+1)
    top = pmax_(m.clone(), ctx.mesh.model)
    part = psum_((part * torch.exp(m - top)[..., None]).contiguous(),
                 ctx.mesh.model)
    out = part[..., :hd] / part[..., hd:]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, -1, hd)  # (B, 1, H, hd)
    if split:
        out = out[:, :, ctx.rank * nh_l:(ctx.rank + 1) * nh_l]
    return out.reshape(b, s, nh_l, 1, hd)


def cache_length(cfg: ArchConfig, kind: str, max_len: int) -> int:
    """Rows of a ``kind`` layer's K/V cache: the window or chunk for the
    ring kinds, ``max_len`` for full attention."""
    if kind == "attn_sw":
        return min(max_len, cfg.window)
    if kind == "attn_chunked":
        return min(max_len, cfg.chunk_size)
    return max_len


def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                  dtype, device, kind: str = "attn") -> dict:
    """K/V cache of ``n_layers`` attention layers of one ``kind``, stacked
    on a leading layer axis: leaves (n_layers, batch, T, kvh, hd), with T
    from `cache_length` (a ring for ``attn_sw`` / ``attn_chunked``)."""
    shape = (n_layers, batch, cache_length(cfg, kind, max_len),
             cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cross_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                        device) -> dict:
    """Encoder K/V bank of ``n_layers`` enc-dec decoder layers, stacked on a
    leading layer axis: ek/ev (n_layers, batch, enc_seq, kvh, hd). Filled
    once at prefill from the encoder output and read by every
    cross-attention decode step (no ring: cross-attention is
    bidirectional over the whole encoded input)."""
    shape = (n_layers, batch, cfg.encoder.enc_seq, cfg.n_kv_heads,
             cfg.head_dim)
    return {"ek": torch.zeros(shape, dtype=dtype, device=device),
            "ev": torch.zeros(shape, dtype=dtype, device=device)}
