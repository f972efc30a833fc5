"""Gemma2-9B.  [arXiv:2408.00118]

42L d_model=3584 16H (GQA kv=8, head_dim 256) d_ff=14336 vocab=256000.
Alternating local(4096-window)/global attention, attention logit softcap 50,
final logit softcap 30, GeGLU, gemma embedding scaling, tied embeddings.
long_500k runs: sliding-window local layers + global layers decode against
the full (data-axis-sharded) cache — linear per decoded token.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="gemma2-9b",
        family="dense",
        citation="arXiv:2408.00118",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        layer_pattern=("attn_sw", "attn"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        ffn_act="gelu",
        ffn_gated=True,
        post_norms=True,
        scale_embeddings=True,
        tie_embeddings=True,
        supports_long_decode=True,
        long_decode_note="1:1 sliding:global alternation (native gemma2)",
    )
)
