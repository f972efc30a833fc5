"""Llama-4 Scout 17B-active / 16 experts.  [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
with an always-on shared expert; iRoPE-style chunked-local attention with a
global layer every 4th layer (chunk 8192) — this is what makes long_500k
decode sub-quadratic-feasible for this arch.
"""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CONFIG = register(
    ArchConfig(
        arch_id="llama4-scout-17b-a16e",
        family="moe",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        layer_pattern=("attn_chunked", "attn_chunked", "attn_chunked", "attn"),
        chunk_size=8192,
        rope_theta=500_000.0,
        ffn_act="silu",
        ffn_gated=True,
        moe=MoESpec(n_experts=16, top_k=1, shared_expert=True),
        supports_long_decode=True,
        long_decode_note="chunked-local attention (3:1 local:global, iRoPE)",
    )
)
