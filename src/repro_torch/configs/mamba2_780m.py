"""Mamba2-780m.  [arXiv:2405.21060]

48L d_model=1536, attention-free SSD (state-space duality), ssm_state=128,
d_inner = 2*d_model = 3072, SSD head dim 64 (48 heads), vocab=50280.
No MLP sub-block (d_ff=0): the Mamba block itself is the mixer+gate.
"""
from repro_torch.configs.base import ArchConfig, SSMSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="mamba2-780m",
        family="ssm",
        citation="arXiv:2405.21060",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        layer_pattern=("ssm",),
        ssm=SSMSpec(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
        use_rope=False,
        tie_embeddings=True,
        norm_eps=1e-5,
        supports_long_decode=True,
        long_decode_note="SSD recurrent state, O(1) per token",
    )
)
