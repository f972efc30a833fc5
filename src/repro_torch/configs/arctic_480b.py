"""Snowflake Arctic 480B.  [hf:Snowflake/snowflake-arctic-base]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.
Dense-MoE hybrid: every layer has a dense residual FFN (d_ff=4864) in
parallel with a 128-expert top-2 MoE (per-expert d_ff=4864).
Pure full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CONFIG = register(
    ArchConfig(
        arch_id="arctic-480b",
        family="moe",
        citation="hf:Snowflake/snowflake-arctic-base",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32_000,
        layer_pattern=("attn",),
        ffn_act="silu",
        ffn_gated=True,
        moe=MoESpec(n_experts=128, top_k=2, dense_residual=True),
        supports_long_decode=False,
        long_decode_note="skipped: pure full-attention stack",
    )
)
