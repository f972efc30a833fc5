"""Shared model utilities: partition specs, the sharding context, norms,
activations, softcap, RoPE, initializers (port of
`repro/models/common.py`).

`ShardCtx` is the counterpart of the reference's: where the reference
names mesh axes for GSPMD to lay activations out by, the port's context
carries this process's `launch.mesh.RankMesh` (or None) and marks where a
tensor-parallel region begins and ends (`enter` / `exit`, the Megatron
pair over the ``model`` group). The reference's activation constraints
change no value, so they have no counterpart; its sequence-parallel gate
``sp`` is recorded, not acted on.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import copy_to_model, reduce_from_model


# ---------------------------------------------------------------------------
# partition specs

class P:
    """A partition spec, as ``jax.sharding.PartitionSpec`` holds one: an
    entry per leading dim of a tensor — a mesh axis name, a tuple of names,
    or None (replicated); dims past the last entry are replicated. Not a
    tuple, so it is one leaf of the port's spec trees (`repro_torch.tree`
    walks tuples); ``tuple(spec)`` gives its entries. As JAX does, a
    one-name tuple entry is kept as the bare name and an empty one as
    None."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def sanitize_spec(mesh_shape: dict, shape, spec: P) -> P:
    """Drop spec axes whose mesh-size does not divide the dim (e.g. 12 whisper
    heads over model=16 → replicate instead of erroring)."""
    out = []
    for d, names in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        tup = names if isinstance(names, tuple) else (names,)
        size = 1
        for n in tup:
            size *= mesh_shape[n]
        out.append(names if shape[d] % size == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# sharding context

class ShardCtx:
    """This process's place in a (data, model) mesh of processes, for the
    model code: ``mesh`` is its `launch.mesh.RankMesh`, or None on one
    device, where every method is a no-op (the one-device route computes
    exactly what it computes without a context)."""

    __slots__ = ("mesh",)

    def __init__(self, mesh: Any = None):
        self.mesh = mesh

    @property
    def n_model(self) -> int:
        return 1 if self.mesh is None else self.mesh.n_model

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def enter(self, x):
        """A tensor-parallel region's input (or a replicated weight used in
        one): identity forward, its gradient summed over ``model``."""
        return x if self.mesh is None else copy_to_model(x, self.mesh.model)

    def exit(self, x):
        """A tensor-parallel region's output, its ranks' partial sums:
        summed over ``model`` forward, identity backward."""
        return x if self.mesh is None else reduce_from_model(x,
                                                             self.mesh.model)


NO_SHARD = ShardCtx()


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

class ShapesOnly:
    """A generator stand-in that draws nothing: `dense_init` and
    `embed_init` (and every init that takes its ``device``) give empty
    meta tensors, so an init of the dense blocks yields the parameter
    tree's shapes and dtypes without allocating it. ``drawn`` lists the
    leaves that a real generator would have drawn, in draw order."""

    device = torch.device("meta")

    def __init__(self):
        self.drawn = []


class KeepPart:
    """A generator stand-in for an init of the dense blocks that holds
    only part of each drawn leaf: `dense_init` and `embed_init` draw from
    ``gen`` as they would, then return ``keep(leaf)`` (one leaf's draw in
    memory at a time)."""

    def __init__(self, gen: torch.Generator, keep):
        self.gen, self.keep, self.device = gen, keep, gen.device


def _draw(gen, shape, scale: float, dtype):
    if isinstance(gen, ShapesOnly):
        w = torch.empty(shape, dtype=dtype, device=gen.device)
        gen.drawn.append(w)
        return w
    real = gen.gen if isinstance(gen, KeepPart) else gen
    w = torch.randn(shape, generator=real, device=real.device,
                    dtype=torch.float32)
    w = w.mul_(scale).to(dtype)
    return gen.keep(w) if isinstance(gen, KeepPart) else w


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype):
    return _draw(gen, shape, in_axis_size ** -0.5, dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    return _draw(gen, shape, 0.02, dtype)
