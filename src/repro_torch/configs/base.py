"""Architecture configuration system (the port's copy of
`repro/configs/base.py`: pure dataclasses, no framework imports)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds usable in ``layer_pattern`` (cycled across n_layers):
#   'attn'         full causal self-attention
#   'attn_sw'      sliding-window causal self-attention (window = cfg.window)
#   'attn_chunked' chunked-local causal attention (chunk = cfg.chunk_size)
#   'attn_bidir'   full bidirectional self-attention (encoders)
#   'ssm'          Mamba-2 SSD block (no separate MLP; mixer includes gating)
#   'rglru'        RG-LRU recurrent block (RecurrentGemma/Griffin)
ATTN_KINDS = ("attn", "attn_sw", "attn_chunked", "attn_bidir")
BLOCK_KINDS = ATTN_KINDS + ("ssm", "rglru")


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts settings for the FFN sub-block."""

    n_experts: int
    top_k: int
    shared_expert: bool = False      # llama4: always-on shared expert
    dense_residual: bool = False     # arctic: dense FFN in parallel w/ MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01    # load-balance loss coefficient


@dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 SSD settings."""

    d_state: int = 128
    head_dim: int = 64               # SSD head size (d_inner / n_heads)
    expand: int = 2                  # d_inner = expand * d_model
    d_conv: int = 4
    chunk: int = 256                 # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUSpec:
    """RG-LRU (Griffin / RecurrentGemma) settings."""

    expand: int = 3                  # d_inner = ceil(expand/2)*2? griffin uses 3*d/2 rounded
    d_conv: int = 4
    block_width: int = 128           # diagonal-recurrence channel block (NTP unit)

    def d_inner(self, d_model: int) -> int:
        # RecurrentGemma uses lru_width = d_model (9b: 4096); keep 1x.
        return d_model


@dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    input_specs() provides precomputed frame embeddings (B, enc_seq, d_model)."""

    n_layers: int
    enc_seq: int = 1500              # whisper: 30 s of audio → 1500 frames


@dataclass(frozen=True)
class ArchConfig:
    # identity
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    citation: str

    # trunk dims
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer structure
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096               # for attn_sw
    chunk_size: int = 8192           # for attn_chunked

    # attention details
    attn_bias: bool = False          # qwen2: QKV bias
    qk_norm: bool = False            # chameleon: qk-layernorm
    attn_softcap: Optional[float] = None   # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    rope_theta: float = 10_000.0
    use_rope: bool = True            # whisper uses absolute positions
    max_position: int = 1_048_576    # abs-position table size when use_rope=False

    # ffn details
    ffn_act: str = "silu"            # silu | gelu | relu2
    ffn_gated: bool = True           # SwiGLU/GeGLU vs plain
    moe: Optional[MoESpec] = None

    # alt mixers
    ssm: Optional[SSMSpec] = None
    rglru: Optional[RGLRUSpec] = None

    # enc-dec
    encoder: Optional[EncoderSpec] = None

    # misc
    norm_type: str = "rms"           # rms | ln (whisper)
    post_norms: bool = False         # gemma2: post-sublayer RMSNorms too
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma-style sqrt(d_model) scaling
    norm_eps: float = 1e-6
    logit_dtype: str = "float32"

    # capability flags
    supports_long_decode: bool = False   # eligible for long_500k
    long_decode_note: str = ""

    # ---- derived ----------------------------------------------------------
    def padded_vocab(self, multiple: int = 256) -> int:
        """Megatron-style vocab padding so embedding/LM-head shard over TP."""
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def block_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def n_params(self) -> int:
        """Approximate parameter count (embedding + trunk), for 6ND math."""
        p = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in ATTN_KINDS:
                qkv = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                out = self.attn_dim * self.d_model
                p += qkv + out
                p += self._ffn_params()
            elif kind == "ssm":
                assert self.ssm is not None
                di = self.ssm.d_inner(self.d_model)
                nh = self.ssm.n_heads(self.d_model)
                # in_proj (z,x,B,C,dt) + out_proj + conv
                p += self.d_model * (2 * di + 2 * self.ssm.d_state + nh)
                p += di * self.d_model
                p += (di + 2 * self.ssm.d_state) * self.ssm.d_conv
            elif kind == "rglru":
                assert self.rglru is not None
                di = self.rglru.d_inner(self.d_model)
                p += self.d_model * di * 2 + di * self.d_model  # x/gate in, out
                p += di * self.rglru.d_conv + 2 * di            # conv + lru gates
                p += self._ffn_params()
            p += 2 * self.d_model  # norms
        if self.encoder is not None:
            # encoder layers: self-attn + ffn; decoder cross-attn extra
            enc = self.encoder.n_layers * (
                4 * self.d_model * self.attn_dim + self._ffn_params() + 2 * self.d_model
            )
            xattn = self.n_layers * (4 * self.d_model * self.attn_dim + self.d_model)
            p += enc + xattn
        return p

    def _ffn_params(self) -> int:
        if self.d_ff == 0:
            return 0
        mult = 3 if self.ffn_gated else 2
        dense = mult * self.d_model * self.d_ff
        if self.moe is None:
            return dense
        p = self.moe.n_experts * dense + self.d_model * self.moe.n_experts  # router
        if self.moe.shared_expert:
            p += dense
        if self.moe.dense_residual:
            p += dense
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        dense = 3 if self.ffn_gated else 2
        ffn_one = dense * self.d_model * self.d_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * ffn_one
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.block_kind(i) in ATTN_KINDS
        )
        return full - n_moe_layers * inactive


# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_arch(arch_id: str) -> ArchConfig:
    from repro_torch import configs  # noqa: F401  (ensure registration ran)

    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> dict:
    from repro_torch import configs  # noqa: F401

    return dict(_REGISTRY)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant of the same family: ≤2–4 layers, d_model ≤ 512,
    ≤4 experts. Keeps the layer pattern semantics (one full cycle)."""
    n_layers = max(2, min(4, len(cfg.layer_pattern)))
    n_kv = 1 if cfg.n_kv_heads == 1 else 2
    changes = dict(
        arch_id=cfg.arch_id + "-smoke",
        n_layers=n_layers,
        d_model=256,
        n_heads=4,
        n_kv_heads=n_kv,
        head_dim=64,
        d_ff=0 if cfg.d_ff == 0 else 512,
        vocab_size=512,
        max_position=4096,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(4, cfg.moe.n_experts), top_k=min(2, cfg.moe.top_k)
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, head_dim=64, chunk=32)
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, block_width=64)
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2, enc_seq=64)
    return dataclasses.replace(cfg, **changes)
