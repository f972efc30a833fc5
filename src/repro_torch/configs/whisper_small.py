"""Whisper-small.  [arXiv:2212.04356]

Enc-dec: 12L encoder + 12L decoder, d_model=768 12H (MHA, kv=12) d_ff=3072
vocab=51865, GELU (non-gated), absolute positions. Conv/mel frontend is a
stub: each served request carries its (1500, 768) frame embeddings
(`serve.Request.enc_input`).
Decoder is 448-token by design → long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, EncoderSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="whisper-small",
        family="audio",
        citation="arXiv:2212.04356",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51_865,
        layer_pattern=("attn",),
        use_rope=False,
        max_position=65_536,
        ffn_act="gelu",
        ffn_gated=False,
        encoder=EncoderSpec(n_layers=12, enc_seq=1500),
        norm_type="ln",
        tie_embeddings=True,
        supports_long_decode=False,
        long_decode_note="skipped: enc-dec, 448-token decoder by design",
    )
)
