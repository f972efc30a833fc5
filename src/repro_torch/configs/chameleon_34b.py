"""Chameleon-34B.  [arXiv:2405.09818]

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 — early-fusion VLM:
the vocab interleaves text tokens and VQ-VAE image codes; the backbone is a
dense decoder with qk-layernorm (chameleon's divergence fix). The VQ image
tokenizer / vision frontend is a STUB per the brief — input_specs() supplies
already-fused token ids. Pure full attention → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="chameleon-34b",
        family="vlm",
        citation="arXiv:2405.09818",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65_536,
        layer_pattern=("attn",),
        qk_norm=True,
        ffn_act="silu",
        ffn_gated=True,
        norm_eps=1e-5,
        supports_long_decode=False,
        long_decode_note="skipped: pure full-attention stack",
    )
)
