"""Pipeline parallelism on process groups (`core.pp_submesh`,
`launch.mesh.make_staged_mesh`, the hand-off of `core.collectives`, and the
pp>1 forms of the rank step, the syncs, the transitions and the session),
on gloo with CPU tensors, against the JAX package.

Fast tier (at most 4 processes a spawn):

* `handoff_accounting`, `_stage_geometry`, `is_staged_mesh` and
  `validate_staged_mesh` equal to the reference's on a sweep (in process,
  as tests/test_pp_submesh.py); the `make_staged_mesh` errors;
* route A — pp=2 on a 2-D (2, 2) mesh, the stage-sequential step —
  microbatches 2, overlap off and on, through a stage-addressed fail →
  repair: losses and grad norms within 1e-5 of the port's emulated pp=2
  session, local batches and ledgers equal, ledgers naming the hit stage
  and equal to `expected_transfer`; losses within 1e-4 of the JAX
  package's dense `make_reference_loss` with SGD;
* route B — pp=2 × (1, 2), a staged mesh of 4 processes — sequential and
  overlapped, held the same way; overlap on equals overlap off exactly and
  the bucketed sync equals the per-leaf one bit for bit on a degraded
  plan; the processes of the stage an event does not hit send nothing;
  counted hand-off bytes equal `handoff_accounting`; a per-rank AdamW
  rollback across plans bit-exact; spares without `allocator=` refused;
* route B at pp=3 × (1, 1): the counted hand-off (``microbatches`` sends a
  boundary) beside the reference's table (``ticks - 1``), both pinned;
* `chip_smoke.py` phase 11 rehearsed at small widths on a (1, 2) mesh.

Slow tier: route B at pp=2 × (2, 2) (8 processes) in lockstep with the
reference's `make_submesh_train_step` (its session on `make_staged_mesh(2,
2, 2)` over 8 fake devices, in a subprocess): losses within 1e-5, ledgers
and hand-off tables equal; and route B at pp=2 × (1, 2) through a canonical
checkpoint the reference's `load_checkpoint` reads, restored bit for bit,
and `TraceRunner(verify=True)` under NTP-PW with quarantine (an SDC
rollback under the degraded plan) against the emulated runner.

Spawned ranks import this module, so JAX is imported inside the tests only.
Every spawn has a deadline and its own file store (`launch.spawn`)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tr
from repro_torch.core import collectives as C
from repro_torch.core import ntp_train as nt
from repro_torch.core import overlap as ov
from repro_torch.core import pp_submesh as tpp
from repro_torch.core.nonuniform import FailurePlan, StagedPlan
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.launch.mesh import RankMesh, make_staged_mesh, \
    make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.optim import AdamWConfig, adamw, sgd
from repro_torch.reshard.transition import expected_transfer
from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, n_layers=4, vocab=128)
LB, SEQ, LR, MB = 4, 16, 0.05, 2
STEPS = 6
DEADLINE = 180


def _cfg(**kw):
    return nt.NTPModelConfig(**dict(KW, **kw))


def _chain(n_data):
    """Stage 1 of the last replica loses a GPU before step 2 (packing puts
    the degraded domain first) and is repaired before step 4."""
    return {2: FailureEvent(step=2, replica=n_data - 1, stage=1),
            4: RecoveryEvent(step=4, replica=0, stage=1)}


def _jax_canonical(**kw):
    import jax

    from repro.core import ntp_train as jnt
    from repro_torch.convert import ntp_params_from_jax

    canon = jax.tree.map(np.asarray, jnt.init_canonical(
        jnt.NTPModelConfig(**dict(KW, **kw)), jax.random.PRNGKey(0)))
    return canon, ntp_params_from_jax(canon, device="cpu")


def _pipe(n_data):
    return SyntheticLMPipeline(DataConfig(KW["vocab"], SEQ, n_data * LB,
                                          seed=0))


def _handoff(counts):
    """(forward, backward) hand-off bytes this process sent."""
    return (counts.get(("send_next", "stage"), (0, 0))[1],
            counts.get(("send_prev", "stage"), (0, 0))[1])


def _train(session, n_data, steps=STEPS, probe_at=None):
    """Drive ``session`` through `_chain`; per step the metrics, the
    collective counts and the local batches; per event the ledger and the
    apply's collectives. At ``probe_at`` (a rank session), also the
    step's bucketed sync against the per-leaf one on the same gradients."""
    pipe, chain = _pipe(n_data), _chain(n_data)
    out = {"loss": [], "grad_norm": [], "ledgers": [], "apply_counts": [],
           "counts": [], "local_batches": [], "ticks": [], "handoff": [],
           "collectives": []}
    for i in range(steps):
        if i in chain:
            C.reset_counts()
            session.apply(chain[i])
            out["apply_counts"].append(C.counts())
            st = session.last_transition
            out["ledgers"].append((st.as_dict(), {
                tuple(int(x) for x in k): v for k, v in st.per_pair.items()}))
        C.reset_counts()
        m = session.step(pipe._batch_np(i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["counts"].append(C.counts())
        out["local_batches"].append(list(session.local_batches))
        out["ticks"].append(m.get("pipeline_ticks"))
        out["collectives"].append(session.step_fn.collectives)
        out["handoff"].append(m.get("handoff"))
        if i == probe_at:
            out["probe"] = _bucketed_equals_per_leaf(session,
                                                     pipe._batch_np(i))
    return out


def _bucketed_equals_per_leaf(session, batch):
    """The step's bucketed sync and the per-leaf sync of the same plan on
    the same gradients: every synced leaf bit for bit equal."""
    step = session.step_fn
    _, grads = step.grads_fn(session.params, batch)
    copy = tr.tree_map(torch.clone, grads)
    per_leaf = ov.make_sync_grads(session.cfg, session.plan,
                                  mode=session.mode, mesh=session.rank_mesh)
    a = step.sync_fn(grads)
    b = per_leaf(copy)
    return all(torch.equal(x, y) for x, y in zip(tr.leaves(a), tr.leaves(b)))


def _numpy(tree):
    return None if tree is None else tr.tree_map(lambda t: t.numpy(), tree)


def _emulated(canon, n_data, overlap, steps=STEPS, **kw):
    s = NTPSession.create(_cfg(**kw), (n_data, 2), local_batch=LB,
                          optimizer=sgd(LR), params=canon, device="cpu",
                          pp=2, microbatches=MB, overlap=overlap)
    out = _train(s, n_data, steps)
    out["canonical"] = _numpy(s.canonical_params(0))
    return out


def _dense_losses(canon_np, n_data, local_batches, **kw):
    """The JAX package's dense reference with SGD under the same sample
    masks (as tests/dist/ntp_equivalence.py trains it)."""
    import jax
    import jax.numpy as jnp

    from repro.core import ntp_train as jnt

    grad = jax.jit(jax.value_and_grad(jnt.make_reference_loss(
        jnt.NTPModelConfig(**dict(KW, **kw)))))
    ref = jax.tree.map(jnp.asarray, canon_np)
    pipe, losses = _pipe(n_data), []
    for i, lbs in enumerate(local_batches):
        mask = jnp.asarray(np.concatenate([np.arange(LB) < b for b in lbs]),
                           dtype=jnp.float32)
        rl, g = grad(ref, jnp.asarray(pipe._batch_np(i)), mask)
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        losses.append(float(rl))
    return losses


def _held(got, want, dense, cfg, n_data):
    """A rank run against the emulated run and the dense reference."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["loss"], dense, rtol=0, atol=1e-4)
    assert got["local_batches"] == want["local_batches"]
    assert got["ledgers"] == want["ledgers"]
    assert got["collectives"] == want["collectives"]
    healthy = FailurePlan(2, (2,) * n_data)
    degraded = FailurePlan(2, (1,) + (2,) * (n_data - 1))
    per_stage = cfg.n_layers // 2
    for (stats, pairs), old, new in ((got["ledgers"][0], healthy, degraded),
                                     (got["ledgers"][1], degraded, healthy)):
        # stage-local: every message is stage 1's
        assert {k[0] for k in pairs} == {1}
        moved = {f: int(m.sum() - np.trace(m))
                 for f, m in expected_transfer(cfg, old, new).items()}
        assert stats["moved_units"] == sum(moved.values()) * per_stage


# ----------------------------------------------------- in-process sweeps

class _StubMesh:
    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.shape = dict(shape)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


def test_static_tables_and_predicates_match_reference():
    """`handoff_accounting` and `_stage_geometry` on a sweep of configs,
    stage plans, batches and microbatches; `is_staged_mesh` and
    `validate_staged_mesh` on a sweep of meshes (stubs and the port's
    `RankMesh`): equal to the reference's, error messages included."""
    from repro.core import nonuniform as jnu
    from repro.core import ntp_train as jnt
    from repro.core import pp_submesh as jpp

    tps = [(2, 2), (1, 2), (2, 1), (1, 1)]
    for n_layers, pp in ((4, 2), (3, 2), (5, 3), (8, 4)):
        tcfg = _cfg(n_layers=n_layers)
        jcfg = jnt.NTPModelConfig(**dict(KW, n_layers=n_layers))
        for k in range(len(tps)):
            stage_tp = [tps[(k + s) % len(tps)] for s in range(pp)]
            tplan = StagedPlan(tuple(FailurePlan(2, t) for t in stage_tp))
            jplan = jnu.StagedPlan(tuple(jnu.FailurePlan(2, t)
                                         for t in stage_tp))
            tg, jg = tpp._stage_geometry(tcfg, tplan), \
                jpp._stage_geometry(jcfg, jplan)
            assert tg[0] == jg[0] and tg[1] == jg[1] and tg[3] == jg[3]
            for tp_, jp_ in zip(tg[2], jg[2]):
                for kind in ("attn", "mlp"):
                    assert np.array_equal(tp_[kind].comp_slots,
                                          np.asarray(jp_[kind].comp_slots))
            for lb, m, seq in ((4, 1, 16), (4, 2, 32), (8, 4, 7)):
                assert tpp.handoff_accounting(
                    tcfg, tplan, local_batch=lb, microbatches=m,
                    seq_len=seq) == jpp.handoff_accounting(
                    jcfg, jplan, local_batch=lb, microbatches=m, seq_len=seq)
    meshes = [None, _StubMesh(("data", "model"), {"data": 2, "model": 4})]
    meshes += [_StubMesh(tpp.STAGE_AXES, {"stage": p, "data": 2, "model": 4})
               for p in (1, 2, 3)]
    meshes += [_StubMesh(("model", "stage", "data"),
                         {"stage": 2, "data": 1, "model": 2})]
    for mesh in meshes:
        assert tpp.is_staged_mesh(mesh) == jpp.is_staged_mesh(mesh)
        if mesh is None:
            continue
        for pp in (1, 2, 3):
            assert _outcome(tpp.validate_staged_mesh, mesh, pp) == \
                _outcome(jpp.validate_staged_mesh, mesh, pp)
    cpu = torch.device("cpu")
    flat = RankMesh(2, 2, 0, 0, None, None, cpu, "gloo")
    staged = RankMesh(2, 2, 1, 1, None, None, cpu, "gloo", stage=1, pp=2)
    assert not tpp.is_staged_mesh(flat) and tpp.is_staged_mesh(staged)
    assert staged.global_rank == 7 and staged.stage_peer(0) == 3
    for mesh, like in ((flat, meshes[1]), (staged, meshes[3])):
        like = _StubMesh(like.axis_names, dict(like.shape, data=2, model=2))
        for pp in (1, 2, 3):
            assert _outcome(tpp.validate_staged_mesh, mesh, pp) == \
                _outcome(jpp.validate_staged_mesh, like, pp)


def test_make_staged_mesh_refuses_one_stage():
    with pytest.raises(ValueError, match="make_test_mesh"):
        make_staged_mesh(1, 2, 2, backend="gloo", device="cpu")


# ------------------------------------------------------------ route A

def _rank_route_a(canon_np):
    """One process of a 2-D (2, 2) mesh: the staged-mesh size check, then
    the pp=2 chain with overlap off and on."""
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_test_mesh(2, 2, backend="gloo", device="cpu")
    try:
        make_staged_mesh(2, 2, 2, backend="gloo", device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    out = {"refused": refused}
    for overlap in (False, True):
        canon = ntp_params_from_jax(canon_np, device="cpu")
        s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                              params=canon, pp=2, microbatches=MB,
                              overlap=overlap)
        assert not getattr(s.step_fn, "submesh", False)
        out[overlap] = _train(s, 2)
        out[overlap]["canonical"] = _numpy(s.canonical_params(mesh.replica))
    return out


def test_route_a_stage_sequential_on_2d_mesh():
    """pp=2 on a 2-D (2, 2) gloo mesh, microbatches 2, through a
    stage-addressed fail → repair, overlap off and on: each held to the
    emulated pp=2 session (losses and grad norms 1e-5, local batches and
    ledgers equal, canonical params 1e-5) and to the JAX dense reference
    (1e-4); the ledgers name stage 1 only and equal `expected_transfer`;
    `make_staged_mesh` refuses a group of the wrong size."""
    canon_np, canon = _jax_canonical()
    ranks = spawn(_rank_route_a, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np,))
    cfg = _cfg()
    for overlap in (False, True):
        want = _emulated(canon, 2, overlap)
        dense = _dense_losses(canon_np, 2, want["local_batches"])
        for r, got in enumerate(ranks):
            _held(got[overlap], want, dense, cfg, 2)
            if r < 2:      # replica 0's processes
                for a, b in zip(tr.leaves(got[overlap]["canonical"]),
                                tr.leaves(want["canonical"])):
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert all("needs 8 processes, the group has 4" in r["refused"]
               for r in ranks)


# ------------------------------------------------------------ route B

def _rank_route_b(canon_np):
    """One process of a pp=2 × (1, 2) staged mesh: the chain with overlap
    off and on (the bucketed sync probed against the per-leaf one at a
    degraded step) and an AdamW rollback across plans."""
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_staged_mesh(2, 1, 2, backend="gloo", device="cpu")
    out = {"stage": mesh.stage}
    # spares at pp>1 need the global allocator
    with pytest.raises(ValueError, match="need the global allocator"):
        NTPSession.create(_cfg(), mesh, pp=2, spares=1)
    for overlap in (False, True):
        s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                              params=ntp_params_from_jax(canon_np,
                                                         device="cpu"),
                              pp=2, microbatches=MB, overlap=overlap)
        assert s.step_fn.submesh and s.step_fn.overlap == overlap
        out[overlap] = _train(s, 1, probe_at=3 if overlap else None)
        out[overlap]["canonical"] = _numpy(s.canonical_params(0))
        out[overlap]["sync"] = s.measure_sync(_pipe(1)._batch_np(0))
    out["rollback"] = _adamw_rollback(canon_np, mesh)
    return out


def _trace_schedule():
    """Stage 1 fails; an SDC suspicion on stage 0 quarantines the replica
    and rolls back to the step-0 snapshot under the degraded plan; its
    clear; the repair with a straggler; its clear."""
    from repro_torch.runtime import (
        ScheduledEvent, SdcClearEvent, SdcSuspectEvent, StragglerClearEvent,
        StragglerEvent)

    return [ScheduledEvent(s, ev) for s, ev in (
        (1, FailureEvent(step=1, stage=1, domain=0)),
        (2, SdcSuspectEvent(step=2, stage=0, domain=0)),
        (3, SdcClearEvent(step=3, stage=0, domain=0)),
        (4, RecoveryEvent(step=4, stage=1, domain=0)),
        (4, StragglerEvent(step=4, stage=0, domain=0, slowdown=2.0)),
        (5, StragglerClearEvent(step=5, stage=0, domain=0, slowdown=2.0)))]


def _trace(canon, mesh):
    """`TraceRunner(verify=True)` (the dense reference on global rank 0)
    over `_trace_schedule` under NTP-PW with quarantine, overlap on, on
    ``mesh`` (a staged mesh, or the emulated (1, 2) shape): the history's
    losses, decisions and the transitions' plans."""
    from repro_torch.runtime import TraceRunner, power_policy

    kw = dict(device="cpu") if isinstance(mesh, tuple) else {}
    s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                          params=canon, pp=2, microbatches=MB, overlap=True,
                          power_policy=power_policy("ntp_pw"),
                          quarantine=True, **kw)
    runner = TraceRunner(s, _trace_schedule(), verify=True)
    hist = runner.run(_pipe(1)._batch_np, 6)
    return {"loss": [h["loss"] for h in hist],
            "decisions": [(h["local_batches"], h["stage_tp"],
                           h.get("power_boost")) for h in hist],
            "transitions": [(t["kind"], t["new_plan"], t.get("rollback"))
                            for t in runner.transitions]}


def _adamw_rollback(canon_np, mesh):
    """An AdamW snapshot after one step (moments set), stage 1 fails, a
    step, then the rollback: params and moments equal bit for bit to
    `pack_rank_params` of this process's own canonical state at the
    snapshot, under the live plan."""
    from repro_torch.convert import ntp_params_from_jax

    s = NTPSession.create(_cfg(), mesh, local_batch=LB,
                          optimizer=adamw(AdamWConfig(lr=1e-2)), pp=2,
                          params=ntp_params_from_jax(canon_np, device="cpu"),
                          microbatches=MB, overlap=True)
    pipe = _pipe(1)
    s.step(pipe._batch_np(0))
    s.snapshot()

    def own(tree):
        """This process's stage's canonical leaves (None elsewhere)."""
        out = tr.tree_map(lambda t: None, nt.canonical_like(s.cfg))
        for path, leaf in nt.rank_canonical_leaves(s.cfg, tree, s.plan,
                                                   mesh):
            tr.set_path(out, path, leaf)
        return out

    keys = ("m", "v")
    snap = [own(s.params)] + [own(s.opt_state[k]) for k in keys]
    s.apply(FailureEvent(step=1, replica=0, stage=1))
    s.step(pipe._batch_np(1))
    s.rollback()
    live = [s.params] + [s.opt_state[k] for k in keys]
    return all(
        torch.equal(a, b) for tree, canon in zip(live, snap)
        for a, b in zip(tr.leaves(tree), tr.leaves(nt.pack_rank_params(
            s.cfg, canon, s.plan, mesh.replica, mesh.rank, mesh.stage))))


def test_route_b_rank_pipeline_on_staged_mesh():
    """pp=2 × (1, 2): 4 processes, each holding its stage's share, through
    the stage-addressed chain with overlap off and on. Losses and grad
    norms within 1e-5 of the emulated pp=2 session and within 1e-4 of the
    JAX dense reference; local batches and ledgers equal; overlap on equal
    to overlap off exactly, its bucketed sync equal to the per-leaf one bit
    for bit on the degraded plan; the counted hand-off bytes of every step
    equal `handoff_accounting`'s table; stage 0's processes send nothing in
    a transition, stage 1's one all-to-all; `pipeline_ticks` and the
    unit-sync counts as the reference's; canonical params of every process
    within 1e-5 of the emulated; the AdamW rollback across plans is
    bit-exact."""
    from repro.core import nonuniform as jnu
    from repro.core import ntp_train as jnt
    from repro.core import overlap as jov

    canon_np, canon = _jax_canonical()
    ranks = spawn(_rank_route_b, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np,))
    cfg = _cfg()
    want = _emulated(canon, 1, False)
    dense = _dense_losses(canon_np, 1, want["local_batches"])
    jcfg = jnt.NTPModelConfig(**KW)
    plans = [(2,), (2,), (1,), (1,), (2,), (2,)]   # stage 1's, step by step
    for r in ranks:
        off, on = r[False], r[True]
        _held(off, want, dense, cfg, 1)
        assert on["loss"] == off["loss"] and on["ledgers"] == off["ledgers"]
        assert on["probe"]
        assert r["rollback"]
        for a, b in zip(tr.leaves(off["canonical"]),
                        tr.leaves(want["canonical"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for got in (off, on):
            # a transition moves stage 1's processes only
            for counts in got["apply_counts"]:
                if r["stage"] == 0:
                    assert counts == {}
                else:
                    assert list(counts) == [("all_to_all", "model")]
                    assert counts[("all_to_all", "model")][0] == 1
            assert got["ticks"] == [MB + 1] * STEPS
            counts = [jov.sync_collectives(
                jcfg, jnu.StagedPlan((jnu.FailurePlan(2, (2,)),
                                      jnu.FailurePlan(2, tp))),
                "ntp", bucketed=got is on) for tp in plans]
            assert got["collectives"] == counts
            assert got["sync"]["collectives"] == counts[-1]
    # the hand-off: every step's sends summed over the processes equal the
    # reference's table (pp=2: microbatches sends a boundary, both ways)
    for overlap in (False, True):
        for i in range(STEPS):
            table = ranks[0][overlap]["handoff"][i]
            assert all(r[overlap]["handoff"][i] == table for r in ranks)
            sent = np.sum([_handoff(r[overlap]["counts"][i]) for r in ranks],
                          axis=0)
            assert tuple(sent) == (table["fwd_bytes"], table["bwd_bytes"])
            assert table["fwd_bytes"] == 4 * (LB // MB) * SEQ * KW["d_model"] \
                * 2 * MB


# ----------------------------------------------------- pp=3 hand-off pin

def _rank_pp3():
    mesh = make_staged_mesh(3, 1, 1, backend="gloo", device="cpu")
    s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                          generator=torch.Generator().manual_seed(0), pp=3,
                          microbatches=MB)
    C.reset_counts()
    m = s.step(_pipe(1)._batch_np(0))
    return float(m["loss"]), _handoff(C.counts()), m["handoff"]


def test_pp3_handoff_sends_real_microbatches_only():
    """pp=3 × (1, 1): the loss equals the emulated session's (1e-5); each
    boundary carries ``microbatches`` activations each way, where the
    reference's table also counts its edge ticks' sends (``ticks - 1 =
    microbatches + 1`` a boundary). Both numbers pinned."""
    ranks = spawn(_rank_pp3, 3, backend="gloo", device="cpu",
                  deadline_s=DEADLINE)
    emu = NTPSession.create(_cfg(), (1, 1), local_batch=LB, optimizer=sgd(LR),
                            generator=torch.Generator().manual_seed(0),
                            device="cpu", pp=3, microbatches=MB)
    want = float(emu.step(_pipe(1)._batch_np(0))["loss"])
    act = 4 * (LB // MB) * SEQ * KW["d_model"]
    table = ranks[0][2]
    assert table["sends_per_boundary"] == MB + 1
    assert table["fwd_bytes"] == act * 2 * (MB + 1)
    sent = [r[1] for r in ranks]
    assert sent == [(act * MB, 0), (act * MB, act * MB), (0, act * MB)]
    assert sum(f for f, _ in sent) == act * 2 * MB == \
        table["fwd_bytes"] - act * 2
    for loss, _, _ in ranks:
        assert abs(loss - want) <= 1e-5


# ------------------------------------------------- chip phase rehearsal

def test_chip_pp_ranks_phase_rehearsed_on_cpu():
    """`chip_smoke.py` phase 11's bookkeeping at small widths on the CPU: a
    pp=2 × (1, 2) staged mesh of 4 gloo processes through the phase's
    chain (through `launch.profile.measure`), against the emulated
    session; the phase's checks pass and it returns launch counts of the
    path's kernels (zero here: the CPU runs their plain versions)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = _cfg(n_layers=2)
    launches = chip_smoke.pp_ranks_phase(
        torch, torch.device("cpu"), cfg=cfg, seq=SEQ, mesh=(1, 2))
    assert launches == {k: 0 for k in chip_smoke.PP_RANKS_KERNELS}


# ------------------------------------------------------------ slow tier

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import ntp_train as nt
from repro.launch.mesh import make_staged_mesh
from repro.optim import sgd
from repro.runtime import FailureEvent, NTPSession, RecoveryEvent

out_path, (KW, LB, SEQ, MB, STEPS, LR) = sys.argv[1], eval(sys.argv[2])
cfg = nt.NTPModelConfig(**KW)
canon = nt.init_canonical(cfg, jax.random.PRNGKey(0))
s = NTPSession.create(cfg, make_staged_mesh(2, 2, 2), local_batch=LB,
                      optimizer=sgd(LR), params=canon, pp=2, microbatches=MB)
assert s._step_fn.submesh
chain = {2: FailureEvent(step=2, replica=1, stage=1),
         4: RecoveryEvent(step=4, replica=0, stage=1)}
from repro.data.pipeline import DataConfig, SyntheticLMPipeline
pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, SEQ, 2 * LB, seed=0))
hist, ledgers = [], []
for i in range(STEPS):
    if i in chain:
        s.apply(chain[i])
        st = s.last_transition
        ledgers.append([st.as_dict(), sorted(
            [[int(x) for x in k], v] for k, v in st.per_pair.items())])
    m = s.step(jnp.asarray(pipe._batch_np(i)))
    hist.append({"loss": float(m["loss"]), "handoff": m["handoff"],
                 "ticks": m["pipeline_ticks"],
                 "local_batches": [int(b) for b in s.local_batches]})
with open(out_path, "w") as f:
    json.dump({"history": hist, "ledgers": ledgers}, f)
"""


def _rank_route_b_2x2(canon_np):
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_staged_mesh(2, 2, 2, backend="gloo", device="cpu")
    s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                          params=ntp_params_from_jax(canon_np, device="cpu"),
                          pp=2, microbatches=MB, overlap=True)
    return _train(s, 2)


def _rank_route_b_lifecycle(canon_np, ckpt):
    """One process of a pp=2 × (1, 2) staged mesh, overlap on: the chain, a
    canonical checkpoint saved and restored, then `_trace`."""
    from repro_torch.convert import ntp_params_from_jax

    mesh = make_staged_mesh(2, 1, 2, backend="gloo", device="cpu")
    s = NTPSession.create(_cfg(), mesh, local_batch=LB, optimizer=sgd(LR),
                          params=ntp_params_from_jax(canon_np, device="cpu"),
                          pp=2, microbatches=MB, overlap=True)
    _train(s, 1)
    out = {"canonical": _numpy(s.canonical_params(0))}
    before = [t.clone() for t in tr.leaves(s.params)]
    s.save(ckpt)
    s.restore(ckpt)
    out["restored"] = all(torch.equal(a, b) for a, b in
                          zip(before, tr.leaves(s.params)))
    out["trace"] = _trace(ntp_params_from_jax(canon_np, device="cpu"), mesh)
    return out


@pytest.mark.slow
def test_route_b_checkpoint_and_trace_on_staged_mesh(tmp_path):
    """pp=2 × (1, 2), overlap on: after the chain a canonical checkpoint
    loads in the reference's `load_checkpoint` (every stage's leaves,
    written by global rank 0) and restores bit for bit;
    `TraceRunner(verify=True)` (the dense reference on global rank 0)
    through a failure, an SDC rollback, a straggler and the repair under
    NTP-PW holds its own checks and equals the emulated runner (losses
    1e-5, decisions and transitions equal)."""
    from repro.checkpoint import load_checkpoint

    canon_np, canon = _jax_canonical()
    ckpt = str(tmp_path / "ck.npz")
    ranks = spawn(_rank_route_b_lifecycle, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(canon_np, ckpt))
    want_trace = _trace(canon, (1, 2))
    assert [t[2] for t in want_trace["transitions"]].count(True) == 1
    for r in ranks:
        assert r["restored"]
        np.testing.assert_allclose(r["trace"]["loss"], want_trace["loss"],
                                   rtol=0, atol=1e-5)
        assert r["trace"]["decisions"] == want_trace["decisions"]
        assert r["trace"]["transitions"] == want_trace["transitions"]
    flat, step = load_checkpoint(ckpt)
    assert step == STEPS and "params/embed" in flat and \
        "params/layers/3/wq" in flat
    np.testing.assert_allclose(flat["params/embed"],
                               ranks[0]["canonical"]["embed"], rtol=0, atol=0)


@pytest.mark.slow
def test_route_b_2x2_lockstep_with_reference_submesh(tmp_path):
    """pp=2 × (2, 2), 8 processes, overlap on, against the reference's
    session on `make_staged_mesh(2, 2, 2)` over 8 fake devices (its
    `make_submesh_train_step`) on the same params, chain and batches:
    losses within 1e-5, local batches, ledgers, ticks and hand-off tables
    equal; the counted hand-off bytes equal the table."""
    canon_np, _ = _jax_canonical()
    path = str(tmp_path / "ref.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, path,
         repr((KW, LB, SEQ, MB, STEPS, LR))],
        capture_output=True, text=True, env=env, timeout=900)
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(path) as f:
        want = json.load(f)
    ranks = spawn(_rank_route_b_2x2, 8, backend="gloo", device="cpu",
                  deadline_s=600, args=(canon_np,))
    for got in ranks:
        np.testing.assert_allclose(
            got["loss"], [h["loss"] for h in want["history"]], rtol=0,
            atol=1e-5)
        assert got["local_batches"] == [h["local_batches"]
                                        for h in want["history"]]
        assert got["ticks"] == [h["ticks"] for h in want["history"]]
        assert got["handoff"] == [h["handoff"] for h in want["history"]]
        assert [[st, sorted([list(k), v] for k, v in pairs.items())]
                for st, pairs in got["ledgers"]] == want["ledgers"]
    for i, h in enumerate(want["history"]):
        sent = np.sum([_handoff(r["counts"][i]) for r in ranks], axis=0)
        assert tuple(sent) == (h["handoff"]["fwd_bytes"],
                               h["handoff"]["bwd_bytes"])
