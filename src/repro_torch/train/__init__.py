"""Step functions of the uniform arch stack (port of `repro.train`)."""
from repro_torch.train.steps import (  # noqa: F401
    Setup,
    check_sharded_arch,
    cross_entropy,
    make_setup,
    vocab_parallel_cross_entropy,
)
