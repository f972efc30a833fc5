"""Synthetic training data of the port (port of `repro.data`)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline  # noqa: F401
