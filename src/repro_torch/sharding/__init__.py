"""Sharding layouts of the uniform arch stack (port of `repro.sharding`)
and their placement on a mesh of processes."""
from repro_torch.sharding.specs import (  # noqa: F401
    data_slice,
    gather,
    local_shape,
    local_shard,
    param_shardings,
    place,
    sanitize_spec,
    splits_over,
    zero1_shardings,
    zero1_spec,
)
