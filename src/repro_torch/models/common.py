"""Shared model utilities: norms, activations, softcap, RoPE, initializers
(port of `repro/models/common.py`; the sharding context has no counterpart
here — the port emulates a replica's ranks on one device)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# norms / activations

def rms_norm(x, weight, eps: float, *, plus_one: bool = False):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (y * w).to(dt)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last axis in f32, with the population variance
    (``jnp.var``'s ddof 0; ``torch.var`` defaults to the unbiased one)."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp(x, 0)),
    with no large-x cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (B,S,hd/2)|(S,hd/2)
    if angles.ndim == 2:  # (S, hd/2) -> broadcast batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# initializers (fan-in scaled normal, Megatron-style), drawn from an explicit
# generator on the generator's device

def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(in_axis_size ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)
