"""Qwen2-7B.  [arXiv:2407.10671]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — SwiGLU, QKV bias.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen2-7b",
        family="dense",
        citation="arXiv:2407.10671",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152_064,
        layer_pattern=("attn",),
        attn_bias=True,
        rope_theta=1_000_000.0,
        ffn_act="silu",
        ffn_gated=True,
        supports_long_decode=False,
        long_decode_note="skipped: pure full-attention stack",
    )
)
