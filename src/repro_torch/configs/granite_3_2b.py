"""Granite-3.0 2B base.  [hf:ibm-granite/granite-3.0-2b-base]

40L d_model=2048 32H (GQA kv=8, head_dim 64) d_ff=8192 vocab=49155 — SwiGLU.
Pure full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="granite-3-2b",
        family="dense",
        citation="hf:ibm-granite/granite-3.0-2b-base",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49_155,
        layer_pattern=("attn",),
        rope_theta=10_000.0,
        ffn_act="silu",
        ffn_gated=True,
        tie_embeddings=True,
        supports_long_decode=False,
        long_decode_note="skipped: pure full-attention stack",
    )
)
