"""Spares at pp>1 through the global repack allocator on every pp>1 route
of the port, against the JAX package's allocator, on the CPU:

(a) the emulated pp=2 session through the chain of
    tests/dist/session_allocator_lifecycle.py (fail (stage 1, domain 0) at
    2, fail (stage 0, domain 1) at 5, repair (1, 0) at 8, repair (0, 1) at
    11; one spare; (2, 4) mesh, the reference's tiny model, SGD 0.05, 14
    steps) through `TraceRunner(verify=True, atol=1e-4)`, with every one of
    that script's assertions; each event's verdict equals the reference's
    `GreedyAllocator` on the same `StagedHealth` and ``current`` with a
    cost model from the reference's `from_trees` (host only: no JAX mesh,
    no subprocess); the recorded telemetry folds, through the port's
    `telemetry_report`, to one (predicted, executed) byte pair per moving
    event, equal;
(b) `launch.train --pp 2 --spares 1 --allocator greedy` and its flag rules;
(c) a 2-D (2, 2) `RankMesh` of 4 gloo processes at pp=2 (the
    stage-sequential step) through the same chain: losses within 1e-5 of
    the emulated allocator session, every process's verdicts equal to each
    other and to the emulated session's, `family_layer_bytes` equal to the
    emulated session's, and the bytes the processes sent, summed, equal to
    each verdict's ``predicted_bytes``;
(d) (slow) the same on a staged mesh, `make_staged_mesh(2, 2, 2)`, 8
    processes: only stage 1's processes send;
and `chip_smoke.py` phase 14's chain and the CPU verdicts it holds the card
to, pinned.

Spawned ranks import this module, so JAX is imported inside the tests only.
Every spawn has a deadline and its own file store (`launch.spawn`)."""
import os

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.cluster import GreedyAllocator
from repro_torch.core import collectives as C
from repro_torch.core import ntp_train as nt
from repro_torch.launch import telemetry_report as trep
from repro_torch.launch.mesh import make_staged_mesh, make_test_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.optim import sgd
from repro_torch.runtime import (
    FailureEvent, NTPSession, RecoveryEvent, ScheduledEvent, StagedPlan,
    TraceRunner,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, n_layers=4, vocab=128)
LB, SEQ, STEPS, LR = 4, 32, 14, 0.05
RANK_SEQ, RANK_STEPS = 16, 12
DEADLINE = 180
# tests/dist/session_allocator_lifecycle.py's chain
CHAIN = {2: ("fail", 1, 0), 5: ("fail", 0, 1), 8: ("repair", 1, 0),
         11: ("repair", 0, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return nt.NTPModelConfig(**KW)


def _event(i):
    kind, stage, domain = CHAIN[i]
    cls = FailureEvent if kind == "fail" else RecoveryEvent
    return cls(step=i, stage=stage, domain=domain)


def _schedule():
    return [ScheduledEvent(i, _event(i)) for i in sorted(CHAIN)]


def _verdict(gp):
    """A `GlobalPlan` as plain values (either package): the fields the
    verdicts are held to, prices to 1e-12 by `_same_verdict`."""
    return {
        "counts": gp.counts, "spare_sites": gp.spare_sites,
        "swaps": gp.swaps, "goodput": gp.goodput,
        "baseline_goodput": gp.baseline_goodput,
        "stage_tp": tuple(p.replica_tp for p in gp.staged_plan.stages),
        "baseline": None if gp.baseline is None else tuple(
            p.replica_tp for p in gp.baseline.stages),
        "predicted_bytes": gp.predicted_bytes,
        "actions": [(a.kind, a.site, a.other, a.absorbed, a.bytes, a.rescue,
                     a.stage, a.order) for a in gp.actions],
        "prices": [(a.cost_s, a.gain_s) for a in gp.actions],
    }


def _same_verdict(got, want):
    a, b = dict(got), dict(want)
    pa, pb = a.pop("prices"), b.pop("prices")
    assert a == b
    assert len(pa) == len(pb) and all(
        abs(x - y) <= 1e-12 for p, q in zip(pa, pb) for x, y in zip(p, q))


def _reference_verdict(jcfg, canon_np, health, current, n1):
    """The JAX package's allocator on the port's ledger and in-place plan,
    its cost model calibrated by the reference's `from_trees` on the JAX
    trees packed from the same canonical params under ``current`` (SGD has
    no param-like optimizer trees)."""
    from repro import cluster as jcl
    from repro.core import nonuniform as jnu
    from repro.core import ntp_train as jnt
    from repro.core.policies import WorkloadGeometry
    from repro.runtime import events as jev

    jh = jev.StagedHealth(tuple(
        jev.ClusterHealth(h.domain_size, h.failed, h.domains_per_replica)
        for h in health.stages))
    jcur = jnu.StagedPlan(tuple(jnu.FailurePlan(p.n1, p.replica_tp)
                                for p in current.stages))
    cost = jcl.TransitionCostModel.from_trees(
        jcfg, [jnt.pack_params(jcfg, canon_np, jcur)], pp=2)
    alloc = jcl.GreedyAllocator(
        goodput=jcl.GoodputModel(n1=n1, geom=WorkloadGeometry(
            n_heads=jcfg.n_kv_groups, local_batch=LB)), cost=cost)
    return _verdict(alloc.plan(jh, spares=1, current=jcur))


# ------------------------------------------------------------ (a) emulated

def test_emulated_session_runs_the_reference_chain():
    """tests/dist/session_allocator_lifecycle.py's assertions on the port's
    emulated pp=2 session, each verdict equal to the reference's, and the
    telemetry's predicted / executed byte pairs equal."""
    import jax

    from repro.core import ntp_train as jnt
    from repro_torch.convert import ntp_params_from_jax

    cfg, jcfg = _cfg(), jnt.NTPModelConfig(**KW)
    canon_np = jax.tree.map(np.asarray,
                            jnt.init_canonical(jcfg, jax.random.PRNGKey(0)))
    allocator = GreedyAllocator()
    session = NTPSession.create(
        cfg, (2, 4), local_batch=LB, optimizer=sgd(LR), device="cpu",
        params=ntp_params_from_jax(canon_np, device="cpu"), pp=2, spares=1,
        allocator=allocator)
    assert session.pp == 2 and isinstance(session.plan, StagedPlan)
    assert session.plan.healthy
    assert allocator.cost is not None and allocator.goodput is not None
    assert allocator.goodput.geom.n_heads == KW["n_kv_groups"]

    rng = np.random.default_rng(0)
    observed, verdicts = [], []

    def on_event(ev, plan):
        observed.append((ev, plan, session.last_transition,
                         session.last_global_plan))
        verdicts.append(_reference_verdict(
            jcfg, canon_np, session.health, runner.transitions[-1]["old_plan"],
            4))

    rec = telemetry.Recorder(sinks=[telemetry.MemorySink()])
    runner = TraceRunner(session, _schedule(), verify=True, atol=1e-4,
                         on_event=on_event)
    with telemetry.recording(rec):
        hist = runner.run(lambda i: rng.integers(0, KW["vocab"],
                                                 (2 * LB, SEQ + 1)), STEPS)
    tps = {h["step"]: h["stage_tp"] for h in hist}
    lbs = {h["step"]: h["local_batches"] for h in hist}

    # step 2: the spare absorbs the stage-1 failure, plan pristine, no bytes
    ev, plan, stats, gp = observed[0]
    assert tps[2] == ((4, 4), (4, 4)) and plan.healthy
    assert gp.spare_sites == ((1, 0, 1),)
    assert gp.predicted_bytes == 0 and stats is None
    assert gp.goodput == 1.0 and gp.baseline_goodput < 1.0
    # step 5: the spare relocates; only stage 1 moves, exactly as priced
    ev, plan, stats, gp = observed[1]
    assert tps[5] == ((4, 3), (4, 4)) and lbs[5] == (3, LB)
    assert gp.spare_sites == ((0, 1, 1),)
    assert stats is not None and stats.moved_units > 0
    moved_stages = {k[0] for k in stats.per_pair}
    priced_stages = {a.stage for a in gp.transitions}
    assert moved_stages == priced_stages == {1}
    assert gp.predicted_bytes == stats.bytes_moved
    assert stats.bytes_moved < stats.dense_bytes
    assert sum(a.bytes for a in gp.transitions) == gp.predicted_bytes
    # step 8: the repair lets the spare cover the leftover failure again
    ev, plan, stats, gp = observed[2]
    assert tps[8] == ((4, 4), (4, 4)) and plan.healthy
    assert gp.spare_sites == ((0, 1, 1),)
    assert {k[0] for k in stats.per_pair} == {1}
    assert gp.predicted_bytes == stats.bytes_moved
    # step 11: full heal, nothing moves
    ev, plan, stats8, gp = observed[3]
    assert plan.healthy and gp.predicted_bytes == 0
    assert stats8 is stats
    assert session.plan.healthy and session.health.healthy
    for _, _, _, gp in observed:
        for a in gp.decisions:
            assert a.rescue or a.cost_s <= a.gain_s + 1e-12, a
        for a in gp.transitions:
            assert a.order is not None and a.bytes >= 0
    errs = [t["canonical_err"] for t in runner.transitions
            if "canonical_err" in t]
    assert len(errs) == 2 and max(errs) < 1e-4
    assert [t["global_plan"] for t in runner.transitions] == \
        [o[3] for o in observed]

    for (_, _, _, gp), want in zip(observed, verdicts):
        _same_verdict(_verdict(gp), want)

    doc = trep.report(list(rec.sinks[0].events()))
    pairs = doc["transition_bytes"]
    assert pairs == [{"predicted": o[3].predicted_bytes,
                      "executed": o[2].bytes_moved}
                     for o in observed[1:3]]
    assert all(p["predicted"] == p["executed"] > 0 for p in pairs)
    assert len(rec.spans("cluster.plan")) == len(CHAIN)


# -------------------------------------------------------------- (b) launcher

def test_launcher_allocator_cpu_smoke(capsys):
    from repro_torch.launch.train import main

    out = main(["--ntp", "--device", "cpu", "--pp", "2", "--spares", "1",
                "--allocator", "greedy", "--fail-at", "2", "--fail-stage",
                "1", "--steps", "4", "--seq-len", "16", "--batch", "2",
                "--log-every", "1"])
    text = capsys.readouterr().out
    assert "allocator greedy spares 1" in text
    assert "    allocator: spares at ((1, 1, 1),) swaps () stage_tp " \
        "((4, 4), (4, 4)) predicted 0 B" in text
    assert out["plan"].healthy
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("argv,match", [
    (["--allocator", "greedy"], "pp=1 sessions already pack globally"),
    (["--pp", "2", "--spares", "1"], "pass --allocator greedy"),
    (["--pp", "2", "--allocator", "annealed"], "invalid choice"),
])
def test_launcher_allocator_flag_errors(argv, match, capsys):
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit):
        main(["--ntp", "--device", "cpu", *argv])
    assert match in capsys.readouterr().err


# ------------------------------------------------ (c), (d) processes

def _train(session, allocator, n_data):
    """The chain on ``session`` (planning with ``allocator``): per step the
    loss, per event the verdict, the ledger's bytes, the stages it moved
    and the bytes this process sent."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

    pipe = SyntheticLMPipeline(DataConfig(KW["vocab"], RANK_SEQ,
                                          n_data * LB, seed=0))
    out = {"loss": [], "verdicts": [], "sent": [], "ledger": [],
           "stages": [],
           "family": dict(allocator.cost.family_layer_bytes)}
    for i in range(RANK_STEPS):
        if i in CHAIN:
            before = session.last_transition
            C.reset_counts()
            session.apply(_event(i))
            out["sent"].append(sum(b for (op, _), (_, b) in
                                   C.counts().items() if op == "all_to_all"))
            st = session.last_transition
            moved = st is not None and st is not before
            out["ledger"].append(st.bytes_moved if moved else 0)
            out["stages"].append(sorted({k[0] for k in st.per_pair})
                                 if moved else [])
            out["verdicts"].append(_verdict(session.last_global_plan))
        out["loss"].append(float(session.step(pipe._batch_np(i))["loss"]))
    return out


def _run_chain(mesh, stage=None, **kw):
    """The allocator session on ``mesh`` (seed-0 weights, this process's
    stage share on a staged mesh) through the chain."""
    allocator = GreedyAllocator()
    canon = nt.init_canonical(_cfg(), torch.Generator().manual_seed(0),
                              device="cpu", pp=2, stage=stage)
    session = NTPSession.create(_cfg(), mesh, local_batch=LB,
                                optimizer=sgd(LR), params=canon, pp=2,
                                microbatches=2, spares=1,
                                allocator=allocator, **kw)
    return _train(session, allocator, 2)


def _rank_worker(staged):
    if staged:
        mesh = make_staged_mesh(2, 2, 2, backend="gloo", device="cpu")
        return dict(_run_chain(mesh, stage=mesh.stage), stage=mesh.stage)
    return _run_chain(make_test_mesh(2, 2, backend="gloo", device="cpu"))


def _held_to_emulated(ranks):
    want = _run_chain((2, 2), device="cpu")
    assert [v["spare_sites"] for v in want["verdicts"]] == \
        [((1, 0, 1),), ((0, 1, 1),), ((0, 1, 1),), ()]
    assert want["stages"] == [[], [1], [1], []]
    assert want["ledger"][1] > 0
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
        assert got["family"] == want["family"]
        assert got["ledger"] == want["ledger"]
        assert got["stages"] == want["stages"]
        for a, b in zip(got["verdicts"], want["verdicts"]):
            _same_verdict(a, b)
        assert got["verdicts"] == ranks[0]["verdicts"]
    sent = np.sum([r["sent"] for r in ranks], axis=0).tolist()
    assert sent == [v["predicted_bytes"] for v in want["verdicts"]]
    return want


def test_rank_mesh_2d_allocator_chain():
    """pp=2 on a 2-D (2, 2) gloo mesh (every process holds every layer)
    with one spare and the allocator through the chain, held to the
    emulated allocator session."""
    ranks = spawn(_rank_worker, 4, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(False,))
    _held_to_emulated(ranks)


@pytest.mark.slow
def test_staged_mesh_allocator_chain():
    """The chain on `make_staged_mesh(2, 2, 2)` (8 processes, each its
    stage's layers): held as on the 2-D mesh, and only stage 1's processes
    send."""
    ranks = spawn(_rank_worker, 8, backend="gloo", device="cpu",
                  deadline_s=DEADLINE, args=(True,))
    _held_to_emulated(ranks)
    for r in ranks:
        if r["stage"] == 0:
            assert r["sent"] == [0] * len(CHAIN)


# ------------------------------------------------ chip_smoke phase 14, pinned

def test_chip_allocator_chain_is_pinned():
    """`chip_smoke.py` phase 14 runs this file's chain, and holds the card's
    verdicts to `_alloc_host_verdicts` (the port on the CPU at the same
    geometry), which equal the reference's allocator on the same ledgers."""
    import importlib.util

    from repro.core import nonuniform as jnu
    from repro.runtime import events as jev

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ALLOC_CHAIN == CHAIN and smoke.ALLOC_STEPS == 12
    got = smoke._alloc_host_verdicts(torch)
    assert got == [
        {"counts": ((0, 0), (0, 0)), "spare_sites": ((1, 0, 1),),
         "swaps": (), "stage_tp": ((4, 4), (4, 4)), "moved": []},
        {"counts": ((0, 0), (1, 0)), "spare_sites": ((0, 1, 1),),
         "swaps": (), "stage_tp": ((4, 4), (3, 4)), "moved": [1]},
        {"counts": ((0, 0), (0, 0)), "spare_sites": ((0, 1, 1),),
         "swaps": (), "stage_tp": ((4, 4), (4, 4)), "moved": [1]},
        {"counts": ((0, 0), (0, 0)), "spare_sites": (), "swaps": (),
         "stage_tp": ((4, 4), (4, 4)), "moved": []}]
    # the reference's allocator on the same ledgers, bound as the session
    # binds it (its geometry; a cost model from the reference's from_trees
    # on the same small model: at step 5 the spare is taken because it
    # saves a stage's repack, not for goodput)
    import jax

    from repro.core import ntp_train as jnt

    jcfg = jnt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=7,
                              head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                              n_layers=4)
    canon_np = jax.tree.map(np.asarray,
                            jnt.init_canonical(jcfg, jax.random.PRNGKey(0)))
    health = jev.StagedHealth.pristine(2, 4, 2)
    current = jnu.StagedPlan((jnu.FailurePlan(4, (4, 4)),) * 2)
    for n, i in enumerate(sorted(CHAIN)):
        ev = _event(i)
        jcls = jev.FailureEvent if isinstance(ev, FailureEvent) \
            else jev.RecoveryEvent
        health = health.apply(jcls(step=i, stage=ev.stage, domain=ev.domain))
        v = _reference_verdict(jcfg, canon_np, health, current, 4)
        assert (v["counts"], v["spare_sites"], v["swaps"], v["stage_tp"]) \
            == (got[n]["counts"], got[n]["spare_sites"], got[n]["swaps"],
                got[n]["stage_tp"])
        current = jnu.StagedPlan(tuple(jnu.FailurePlan(4, t)
                                       for t in v["stage_tp"]))
