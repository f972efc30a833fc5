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

The ``*_rank`` forms run the reference's shard_map body on one (replica,
rank) process of a `launch.mesh.RankMesh`: the rank gathers its send
buckets with the single-rank `reshard_pack` kernel from its replica's
tables (`reshard.engine.device_tables`), one `all_to_all_units` over the
model group moves every bucket (``s_max`` rows to each peer, as the
reference's tiled all-to-all), and stays and the receive scatter follow
`reshard.engine.reshard_ranks`; ``psum('data')`` is an all-reduce over the
data group.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives as C
from repro_torch.core.nonuniform import StackedTables, WeightPlan
from repro_torch.kernels.reshard_pack import reshard_pack
from repro_torch.launch.mesh import RankMesh
from repro_torch.reshard.engine import device_tables, reshard_ranks, \
    zero_pad_slot


def reshard(x: torch.Tensor, tables: StackedTables,
            out=None) -> torch.Tensor:
    """Convert every replica's unit buffers ``x`` (D, n1, buf, ...) between
    layouts: replica d reshards under its own tables ``tables.replica(d)``,
    straight into its slice of the result (``out`` when given; it must not
    overlap ``x``)."""
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    for d in range(x.shape[0]):
        reshard_ranks(x[d], tables.replica(d), out=out[d])
    return out


def ntp_sync_gradient(g: torch.Tensor, wp: WeightPlan,
                      out=None) -> torch.Tensor:
    """Full NTP gradient synchronization of one unit-buffered gradient stack
    (D, n1, buf, ...): pre-sync reshard → all-reduce over DP → post-sync
    reshard. The replicas' pre-sync layouts are summed as each is made, and
    the post-sync reshard writes into ``out`` when given — ``g`` itself may
    be ``out``: its values are dead once summed."""
    total = None
    for d in range(g.shape[0]):
        part = reshard_ranks(g[d], wp.pre.replica(d))
        total = part if total is None else total.add_(part)
        del part
    return reshard(total.unsqueeze(0).expand_as(g), wp.post, out=out)


def uniform_sync_gradient(g: torch.Tensor, out=None) -> torch.Tensor:
    """Healthy-path baseline: plain DP all-reduce over the leading replica
    dim (what NTP degenerates to when every replica is healthy); into
    ``out`` (``g`` itself may be ``out``) when given."""
    total = g.sum(dim=0, keepdim=True)
    if out is None:
        return total.expand_as(g).contiguous()
    return out.copy_(total.expand_as(g))


def reshard_rank(x: torch.Tensor, tables: StackedTables,
                 mesh: RankMesh) -> torch.Tensor:
    """This rank's unit buffer ``x`` (buf, ...) converted between layouts
    under its replica's tables: send-bucket gather → all-to-all over the
    model group → stays + scatter (a collective of the replica)."""
    buf = x.shape[0]
    if buf != tables.buf:
        raise ValueError(f"buffer of {buf} slots, tables expect {tables.buf}")
    t = device_tables(tables.replica(mesh.replica), x.device)
    r, n, s_max = mesh.rank, mesh.n_model, tables.s_max
    xp = zero_pad_slot(x, axis=0)
    send = reshard_pack(xp.reshape(buf + 1, -1), t["send"][r])
    out = xp[t["stay"][r]]
    del xp                  # the padded copy goes before the receive buffer
    recv = C.all_to_all_units(send.reshape(n * s_max, -1), [s_max] * n,
                              [s_max] * n, mesh.model)
    del send
    if len(t["recv_src"][r]):                   # pad (== buf) drops
        out[t["recv_dst"][r]] = recv.reshape(
            n * s_max, *x.shape[1:])[t["recv_src"][r]]
    return out


def ntp_sync_gradient_rank(g: torch.Tensor, wp: WeightPlan,
                           mesh: RankMesh) -> torch.Tensor:
    """`ntp_sync_gradient` of one rank's gradient buffer (buf, ...):
    pre-sync reshard → all-reduce over data → post-sync reshard."""
    return reshard_rank(C.psum_(reshard_rank(g, wp.pre, mesh), mesh.data),
                        wp.post, mesh)


def uniform_sync_gradient_rank(g: torch.Tensor,
                               mesh: RankMesh) -> torch.Tensor:
    """`uniform_sync_gradient` of one rank's gradient: an all-reduce over
    data (in place)."""
    return C.psum_(g.contiguous(), mesh.data)
