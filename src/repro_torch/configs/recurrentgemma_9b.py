"""RecurrentGemma-9B (Griffin).  [arXiv:2402.19427]

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000.
Pattern: (rglru, rglru, attn_sw) — RG-LRU : local attention 2:1 with a
2048-token sliding window. GeGLU MLP, gemma-style embedding scaling.
Recurrent + local-attn → long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, RGLRUSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="recurrentgemma-9b",
        family="hybrid",
        citation="arXiv:2402.19427",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        layer_pattern=("rglru", "rglru", "attn_sw"),
        window=2048,
        rglru=RGLRUSpec(d_conv=4, block_width=128),
        ffn_act="gelu",
        ffn_gated=True,
        scale_embeddings=True,
        tie_embeddings=True,
        supports_long_decode=True,
        long_decode_note="RG-LRU state + 2k sliding-window attention",
    )
)
