"""Optimizers of the NTP training path (port of `repro.optim`)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, global_norm,
)
from repro_torch.optim.base import Optimizer, adamw, sgd  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
