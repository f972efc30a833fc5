"""Config registry of the port: importing this package registers every
arch of the reference, each a field-for-field copy of the reference's
file, and all are served (`models.transformer`): the dense attention
archs qwen2-7b, granite-3-2b, minitron-4b, chameleon-34b (qk-norm) and
gemma2-9b (post-norms, softcaps, sliding/global alternation);
mamba2-780m; recurrentgemma-9b (RG-LRU blocks with sliding-window MQA);
whisper-small (encoder-decoder, LayerNorm, absolute positions); and the
MoE archs llama4-scout and arctic-480b, whose widths also size the
NTP-MoE prototype."""
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
    chameleon_34b,
    gemma2_9b,
    granite_3_2b,
    llama4_scout,
    mamba2_780m,
    minitron_4b,
    qwen2_7b,
    recurrentgemma_9b,
    whisper_small,
)

ARCH_IDS = tuple(all_archs().keys())
