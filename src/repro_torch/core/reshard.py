"""The NTP gradient reshard (paper §3.1/§4.1) on the emulated mesh (port of
`repro/core/reshard.py`).

The reference runs inside shard_map over ('data', 'model'): every rank
gathers its send buckets with the static Algorithm-1 tables, one tiled
all-to-all over the model axis moves them, and gradient sync is
reshard(pre) → psum('data') → reshard(post). The port holds every
(replica, rank) buffer of a weight in one ``(D, n1, buf, ...)`` stack on
one device, so the all-to-all is the host-unrolled transpose of
`reshard.engine.reshard_ranks` — whose send-bucket gather is the
hand-written `reshard_pack` kernel, in place of the jnp gather ``xp[send]``
at `repro/core/reshard.py:46` — and ``psum('data')`` is a sum over the
``D`` dim. Pad slots gather zeros and scatter-drop, so they come out as
exact zeros.
"""
from __future__ import annotations

import torch

from repro_torch.core.nonuniform import StackedTables, WeightPlan
from repro_torch.reshard.engine import reshard_ranks


def reshard(x: torch.Tensor, tables: StackedTables) -> torch.Tensor:
    """Convert every replica's unit buffers ``x`` (D, n1, buf, ...) between
    layouts: replica d reshards under its own tables ``tables.replica(d)``."""
    return torch.stack([reshard_ranks(x[d], tables.replica(d))
                        for d in range(x.shape[0])])


def ntp_sync_gradient(g: torch.Tensor, wp: WeightPlan) -> torch.Tensor:
    """Full NTP gradient synchronization of one unit-buffered gradient stack
    (D, n1, buf, ...): pre-sync reshard → all-reduce over DP → post-sync
    reshard."""
    g_sync = reshard(g, wp.pre)
    g_sync = g_sync.sum(dim=0, keepdim=True).expand_as(g_sync)
    return reshard(g_sync, wp.post)


def uniform_sync_gradient(g: torch.Tensor) -> torch.Tensor:
    """Healthy-path baseline: plain DP all-reduce over the leading replica
    dim (what NTP degenerates to when every replica is healthy)."""
    return g.sum(dim=0, keepdim=True).expand_as(g).contiguous()
