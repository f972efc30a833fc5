"""Continuous-batching serve engine for ONE NTP replica (port of
`repro/serve/engine.py`).

A fixed pool of cache slots, each holding one in-flight request at its
own position; `Model.decode_slots` advances every slot in one batched
step (an MoE FFN dispatching each slot on its own, as the reference's
vmap does). The cache is the model's grouped dict (one group per
layer-pattern entry, ring caches for sliding-window and chunked layers,
an enc-dec config's encoder K/V bank in every group), and every group is
admitted, resharded and zeroed alike. On a TP transition the cache is
resharded mid-decode through `reshard.ShardedState`: KV heads (attention),
SSD heads (Mamba-2 h and conv state), RG-LRU gate blocks (h and conv) and
encoder K/V heads move between the replica's (emulated) ranks through the
hand-written `reshard_pack` send-bucket kernel, and decoding continues on
the dense view (shard ∘ gather is the bit-exact identity).

Attention requests are admitted by one padded prefill. Recurrent state is
cumulative, so a padded prefill would fold pad tokens into it: recurrent
archs are admitted token by token, a length-1 prefill followed by
teacher-forced one-token decode steps, as in the reference. An enc-dec
request carries its ``enc_input`` (enc_seq, d_model); the (first)
prefill encodes it and banks the encoder K/V, and a re-admission after
preemption encodes it again.

A replica at TP ``t < n1`` decodes slower by the head-quantized
`stage_slowdown`, modelled as a token-bucket ``rel_speed``; its KV memory
shrinks with the surviving ranks, so the slot pool shrinks ∝ t/n1 and
over-capacity requests are preempted. A preempted request keeps its
generated prefix, and greedy decode makes the resumed stream identical to
an uninterrupted one with full-precision caches.

The dense cache is updated in place (prefill writes, per-slot decode
writes, slot zeroing), where the reference rebuilds immutable arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (
    DECODER_KINDS, RECURRENT_KINDS, build_model,
)
from repro_torch.reshard.state import ShardedState
from repro_torch.reshard.units import cache_unit_resolver


def validate_serve_cfg(cfg: ArchConfig) -> set:
    """Reject configs the serve engine cannot run, before any model is
    built. Returns the set of block kinds in the pattern."""
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    if not kinds <= set(DECODER_KINDS):
        raise ValueError(
            f"serve engine supports kinds {DECODER_KINDS}; "
            f"{cfg.arch_id} has kinds {sorted(kinds)}"
        )
    return kinds


@dataclass
class Request:
    """One generation request. ``generated`` survives preemption: a resumed
    request re-prefills prompt+generated and (greedy) continues the exact
    same token stream."""

    rid: int
    prompt: np.ndarray                   # (L,) int32
    max_new: int
    arrival: float = 0.0                 # router ticks
    deadline: Optional[float] = None     # SLO: completion-time bound (ticks)
    # enc-dec only: the (enc_seq, d_model) frame embeddings, kept so that a
    # re-admission after preemption encodes them again (not checkpointed,
    # as in the reference)
    enc_input: Optional[np.ndarray] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False
    first_token_time: Optional[float] = None  # router ticks
    finish_time: Optional[float] = None
    preemptions: int = 0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.generated)

    def full_prompt(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self.prompt, np.int64),
             np.asarray(self.generated, np.int64)]
        ).astype(np.int32)


class ServeEngine:
    """Slot-scheduled continuous-batching engine for one serving replica."""

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        n1: int,
        slots: int = 8,
        max_len: int = 96,
        prefill_len: int = 32,
        dtype=torch.float32,
        model=None,                     # share one Model across replicas
    ):
        kinds = validate_serve_cfg(cfg)
        # a ring cache keeps only the trailing window or chunk: a longer
        # padded prefill would leave pad K/V posing as valid tokens
        if "attn_sw" in kinds and prefill_len > cfg.window:
            raise ValueError(
                f"prefill_len={prefill_len} exceeds the sliding-window ring "
                f"cache: {cfg.arch_id} has window={cfg.window} (attn_sw "
                "keeps only the trailing window, so a longer prefill would "
                "leave pad K/V posing as valid tokens)"
            )
        if "attn_chunked" in kinds and prefill_len > cfg.chunk_size:
            raise ValueError(
                f"prefill_len={prefill_len} exceeds the chunked-attention "
                f"ring cache: {cfg.arch_id} has chunk_size={cfg.chunk_size} "
                "(attn_chunked keeps only the current chunk, so a longer "
                "prefill would leave pad K/V posing as valid tokens)"
            )
        if prefill_len > max_len:
            raise ValueError(
                f"prefill_len={prefill_len} exceeds max_len={max_len}: a "
                "request could never decode past its own prefill"
            )
        self._recurrent = bool(kinds & set(RECURRENT_KINDS))
        self.cfg = cfg
        # building the model validates the config (`validate_model_cfg`)
        self.model = model if model is not None else build_model(cfg)
        self.device = self.model.device
        self.params = params
        self.n1 = n1
        self._tp = n1
        self.slots, self.max_len, self.prefill_len = slots, max_len, prefill_len
        self._dtype = dtype
        # working state is the DENSE slot cache; the rank-sharded form is
        # materialized only at TP transitions (apply_tp)
        self._cache = self.model.init_slot_cache(slots, max_len, dtype)
        self._unit_resolver = cache_unit_resolver(cfg)
        for name in self._cache:
            self._unit_resolver(name)
        self.last_reshard: Dict = {}
        self.dead = False
        self.draining = False                # SDC quarantine: no new admits
        self.rel_speed = 1.0                 # tokens per wall tick (<= 1)
        self.power_boost = 1.0
        self._credit = 0.0

        self._rid = np.full(slots, -1, np.int64)
        self._pos = np.zeros(slots, np.int64)
        self._cur_tok = np.zeros(slots, np.int64)
        self._admit_order = np.zeros(slots, np.int64)    # for preemption LIFO
        self._admitted = 0
        self._req: Dict[int, Request] = {}
        self._finished: List[Request] = []
        self.stats = {"tokens": 0, "prefills": 0, "preemptions": 0,
                      "reshards": 0, "reshard_bytes": 0}

    # ------------------------------------------------------------ introspect

    @property
    def tp(self) -> int:
        return self._tp

    @property
    def n_active(self) -> int:
        return int((self._rid >= 0).sum())

    @property
    def capacity(self) -> int:
        """Usable slots: per-rank KV memory is fixed, so total cache memory
        (and with it the slot pool) shrinks ∝ surviving ranks."""
        if self.dead:
            return 0
        return max(1, (self.slots * self._tp) // self.n1)

    def can_admit(self) -> bool:
        return ((not self.dead) and (not self.draining)
                and self.n_active < self.capacity)

    @property
    def in_flight(self) -> List[Request]:
        return [self._req[r] for r in self._rid[self._rid >= 0]]

    @property
    def cache(self) -> Dict[str, torch.Tensor]:
        """The dense slot-stacked cache, by `models.transformer.
        cache_groups` (leaves (layers, slots, ...): k/v (layers, slots, T,
        kvh, hd); Mamba-2 h (layers, slots, nh, hp, ds) and conv (layers,
        slots, K-1, di+2ds); RG-LRU h (layers, slots, di) and conv
        (layers, slots, K-1, di); an enc-dec config's ek/ev (layers,
        slots, enc_seq, kvh, hd))."""
        return self._cache

    # ---------------------------------------------------------------- admit

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` (prompt + any pre-preemption prefix) into a free
        slot. The prefill determines the request's next token, but it is
        only EMITTED by a later credited tick."""
        if not self.can_admit():
            return False
        enc = self._enc_input(req)
        b = int(np.flatnonzero(self._rid < 0)[0])
        toks = req.full_prompt()
        n = len(toks)
        if not (0 < n and n + req.remaining <= self.max_len):
            raise ValueError(
                f"request {req.rid}: {n} prompt tokens + {req.remaining} to "
                f"generate do not fit max_len={self.max_len}"
            )

        cache1 = self.model.init_cache(1, self.max_len, self._dtype)
        if self._recurrent:
            # the prompt token by token: a length-1 prefill, then
            # teacher-forced one-token decode steps
            # (an enc-dec config banks the encoder K/V in this prefill)
            logits, cache1 = self.model.prefill(
                self.params, self._tokens(toks[:1][None]), cache1,
                enc_input=enc,
            )
            last_logits, pos = logits[0, 0], 1
            for t in toks[1:]:
                last, cache1 = self.model.decode_step(
                    self.params, cache1, self._tokens([[t]]), pos
                )
                pos += 1
                last_logits = last[0, 0]
        else:
            last_logits, pos, cache1 = self._prefill_padded(toks, cache1,
                                                            enc)
        first = int(torch.argmax(last_logits[: self.cfg.vocab_size]))

        for name, leaf in self._cache.items():
            leaf[:, b] = cache1[name][:, 0]
        self._rid[b] = req.rid
        self._pos[b] = pos
        self._cur_tok[b] = first        # pending: emitted by the next tick
        self._admit_order[b] = self._admitted
        self._admitted += 1
        self._req[req.rid] = req
        self.stats["prefills"] += 1
        return True

    def _enc_input(self, req: Request):
        """An enc-dec request's ``enc_input`` as a (1, enc_seq, d_model)
        f32 tensor on the engine's device, checked before a slot is taken
        (None for a decoder-only config)."""
        enc = self.cfg.encoder
        if enc is None:
            return None
        if req.enc_input is None:
            raise ValueError(
                f"{self.cfg.arch_id} is enc-dec: Request.enc_input must "
                f"carry the ({enc.enc_seq}, {self.cfg.d_model}) frame "
                "embeddings"
            )
        x = torch.as_tensor(np.asarray(req.enc_input, np.float32),
                            device=self.device)
        if tuple(x.shape) != (enc.enc_seq, self.cfg.d_model):
            raise ValueError(
                f"Request.enc_input has shape {tuple(x.shape)}, expected "
                f"({enc.enc_seq}, {self.cfg.d_model})"
            )
        return x[None]

    def _prefill_padded(self, toks, cache1, enc=None):
        """Attention admission: one prefill of the first ``prefill_len``
        tokens (zero-padded), the overflow of a resumed request fed
        teacher-forced through the decode path. Returns (logits of the last
        prompt token, next write position, cache)."""
        n, p = len(toks), self.prefill_len
        padded = np.zeros(p, np.int64)
        head = toks[: min(n, p)]
        padded[: len(head)] = head
        logits, cache1 = self.model.prefill(
            self.params, self._tokens(padded[None]), cache1, enc_input=enc
        )
        if n <= p:
            return logits[0, n - 1], n, cache1
        pos = p
        for t in toks[p:]:
            last, cache1 = self.model.decode_step(
                self.params, cache1, self._tokens([[t]]), pos
            )
            pos += 1
        return last[0, 0], pos, cache1

    # ----------------------------------------------------------------- tick

    def tick(self) -> List[Request]:
        """One wall tick: iff enough speed credit accrued, every active slot
        EMITS its pending token and the batched decode computes the next
        one. Returns the requests that finished."""
        if self.dead or self.n_active == 0:
            return []
        self._credit += self.rel_speed
        if self._credit < 1.0:
            return []
        self._credit -= 1.0

        logits, self._cache = self.model.decode_slots(
            self.params, self._cache, self._tokens(self._cur_tok),
            self._tokens(self._pos),
        )
        nxt = torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1).cpu().numpy()
        self._finished = []
        for b in np.flatnonzero(self._rid >= 0):
            req = self._req[int(self._rid[b])]
            req.generated.append(int(self._cur_tok[b]))
            self.stats["tokens"] += 1
            if req.remaining <= 0:
                self._finish(int(b))
            else:
                self._pos[b] += 1
                self._cur_tok[b] = nxt[b]
        out, self._finished = self._finished, []
        return out

    def _finish(self, b: int) -> None:
        req = self._req.pop(int(self._rid[b]))
        req.done = True
        self._rid[b] = -1
        self._finished.append(req)

    # ------------------------------------------------------------ lifecycle

    def apply_tp(self, new_tp: int, *, rel_speed: float = 1.0,
                 power_boost: float = 1.0) -> List[Request]:
        """Consume a TP transition: reshard the live KV cache (or die/revive
        on 0 <-> >0), update the speed model, and preempt whatever no longer
        fits the shrunk slot pool. Returns the preempted requests."""
        preempted: List[Request] = []
        if new_tp == 0:
            if not self.dead:
                preempted = self._preempt_all()
                self.dead = True
                self.last_reshard = {"tp_from": self._tp, "tp_to": 0,
                                     "moved_units_per_rank": 0,
                                     "bytes_moved": 0}
                self._tp = 0
                self.rel_speed, self.power_boost = 0.0, 1.0
            return preempted
        if self.dead:
            # revival: no cache state survived death — fresh zero buffers
            self.dead = False
            for leaf in self._cache.values():
                leaf.zero_()
            self.last_reshard = {"tp_from": 0, "tp_to": new_tp,
                                 "moved_units_per_rank": 0, "bytes_moved": 0}
        elif new_tp != self._tp:
            # the physical move: shard into the OLD rank layout, run the
            # KV-head / SSD-head all-to-all, keep the new dense view
            state = ShardedState(self._cache, self._unit_resolver, self.n1,
                                 tp=self._tp)
            st = state.apply_tp(new_tp)
            self._cache = state.gather()
            self.last_reshard = st
            self.stats["reshards"] += 1
            self.stats["reshard_bytes"] += st["bytes_moved"]
        self._tp = new_tp
        self.rel_speed, self.power_boost = rel_speed, power_boost
        while self.n_active > self.capacity:
            preempted.append(self._preempt_one())
        return preempted

    def _preempt_one(self) -> Request:
        """Preempt the most-recently-admitted active request (least sunk
        prefill+decode work to redo)."""
        active = np.flatnonzero(self._rid >= 0)
        b = int(active[np.argmax(self._admit_order[active])])
        req = self._req.pop(int(self._rid[b]))
        req.preemptions += 1
        self._rid[b] = -1
        for leaf in self._cache.values():
            leaf[:, b] = 0
        self.stats["preemptions"] += 1
        return req

    def _preempt_all(self) -> List[Request]:
        return [self._preempt_one() for _ in range(self.n_active)]
