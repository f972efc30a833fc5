"""Minitron-4B (pruned Nemotron).  [arXiv:2407.14679]

32L d_model=3072 24H (GQA kv=8, head_dim 128) d_ff=9216 vocab=256000.
Nemotron-style squared-ReLU non-gated MLP. Pure full attention →
long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="minitron-4b",
        family="dense",
        citation="arXiv:2407.14679",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256_000,
        layer_pattern=("attn",),
        ffn_act="relu2",
        ffn_gated=False,
        supports_long_decode=False,
        long_decode_note="skipped: pure full-attention stack",
    )
)
