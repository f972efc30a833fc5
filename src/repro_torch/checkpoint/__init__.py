"""Canonical checkpoints in the reference's ``.npz`` format."""
from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
