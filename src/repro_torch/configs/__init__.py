"""Config registry of the port: importing this package registers the archs
the port serves so far (qwen2-7b, mamba2-780m)."""
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

from repro_torch.configs import mamba2_780m, qwen2_7b  # noqa: F401,E402

ARCH_IDS = tuple(all_archs().keys())
