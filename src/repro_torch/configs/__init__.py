"""Config registry of the port: importing this package registers the archs
ported so far. qwen2-7b and mamba2-780m are served (`models.transformer`);
llama4-scout and arctic-480b are registered for the MoE FFN of
`models.mlp` and the widths of the NTP-MoE prototype, and are not built as
served models yet (`models.transformer.validate_model_cfg` refuses MoE)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    EncoderSpec,
    MoESpec,
    RGLRUSpec,
    SSMSpec,
    all_archs,
    get_arch,
    reduced,
)

from repro_torch.configs import (  # noqa: F401,E402
    arctic_480b,
    llama4_scout,
    mamba2_780m,
    qwen2_7b,
)

ARCH_IDS = tuple(all_archs().keys())
