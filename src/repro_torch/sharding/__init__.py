"""Sharding layouts of the uniform arch stack (port of `repro.sharding`)."""
from repro_torch.sharding.specs import (  # noqa: F401
    param_shardings,
    sanitize_spec,
    zero1_shardings,
    zero1_spec,
)
