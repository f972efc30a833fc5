"""Deterministic synthetic data pipeline and input specs (port of
`repro/data/pipeline.py`).

``input_specs`` gives every model input's shape and dtype (and, for a mesh
shape, its spec) for one (arch × input shape), as the reference's
dry-run stand-ins do, with no allocation; ``shard_batch`` cuts a global
batch to one process's rows by those specs.

The synthetic corpus is a seeded affine Markov stream with a small
uniform-noise fraction, made in numpy exactly as the reference makes it,
so both packages train on bit-identical tokens: `_batch_np` is the (B, S+1)
int32 array (the NTP prototype's step takes it whole), ``batch(step)`` the
(tokens, targets) split as int32 tensors on the pipeline's device, and
iterating the pipeline yields ``batch(0)``, ``batch(1)``, ...
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.mode import resolve_device
from repro_torch.models.common import P, sanitize_spec
from repro_torch.sharding.specs import local_shard


# ---------------------------------------------------------------------------
# input specs

class InputSpec(NamedTuple):
    """One step input: its shape, dtype and, for a mesh shape, its
    (sanitized) partition spec."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[P] = None


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                mesh_shape: Optional[dict] = None,
                dp_axes: Tuple[str, ...] = ("data",)) -> Dict[str, InputSpec]:
    """Every *data* input of the step function for (cfg, shape):

    train   -> tokens/targets (B, S) int32
    prefill -> tokens (B, S) int32
    decode  -> tokens (B, 1) int32 + pos () int32
    Audio archs additionally get enc_input (B, enc_seq, d) bf16 frame
    embeddings (train/prefill) or enc_out (decode). With ``mesh_shape``
    each batched input's batch is over ``dp_axes`` (``pos`` has no spec)."""
    b, s = shape.global_batch, shape.seq_len

    def one(shp, dtype):
        if mesh_shape is None:
            return InputSpec(shp, dtype)
        return InputSpec(shp, dtype,
                         sanitize_spec(mesh_shape, shp, P(tuple(dp_axes))))

    out: Dict[str, InputSpec] = {}
    if shape.kind == "train":
        out["tokens"] = one((b, s), torch.int32)
        out["targets"] = one((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = one((b, s), torch.int32)
    elif shape.kind == "decode":
        out["tokens"] = one((b, 1), torch.int32)
        out["pos"] = InputSpec((), torch.int32)
    else:
        raise ValueError(shape.kind)

    if cfg.encoder is not None:
        name = "enc_out" if shape.kind == "decode" else "enc_input"
        out[name] = one((b, cfg.encoder.enc_seq, cfg.d_model), torch.bfloat16)
    return out


def shard_batch(batch: Dict[str, Any], specs: Dict[str, InputSpec],
                mesh) -> Dict[str, Any]:
    """This process's part of a global ``batch`` on a `launch.mesh.RankMesh`:
    each input with a spec cut by it (its replica's rows), views where the
    inputs are tensors; inputs without one (``pos``) as given."""
    return {k: (v if k not in specs or specs[k].spec is None
                else local_shard(v, specs[k].spec, mesh))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# synthetic corpus

@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05  # fraction of uniformly-random tokens


class SyntheticLMPipeline:
    """Affine Markov token stream: t_{i+1} = (a·t_i + b) mod V, with a small
    uniform-noise fraction. Deterministic given (seed, step). ``device``:
    where `batch` puts its tensors (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = device
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # affine params coprime-ish with V for long cycles
        self.a = int(rng.integers(2, max(3, v - 1))) | 1
        self.b = int(rng.integers(1, v))

    def _batch_np(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        t0 = rng.integers(0, c.vocab_size, size=(c.global_batch, 1))
        toks = [t0]
        for _ in range(c.seq_len):
            nxt = (self.a * toks[-1] + self.b) % c.vocab_size
            noise_mask = rng.random((c.global_batch, 1)) < c.noise
            rand = rng.integers(0, c.vocab_size, size=(c.global_batch, 1))
            toks.append(np.where(noise_mask, rand, nxt))
        return np.concatenate(toks, axis=1).astype(np.int32)  # (B, S+1)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "targets"}: (B, S) int32 tensors on the device, the
        targets the tokens shifted by one."""
        arr = torch.from_numpy(self._batch_np(step))
        dev = resolve_device(self.device)
        return {"tokens": arr[:, :-1].to(dev), "targets": arr[:, 1:].to(dev)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
