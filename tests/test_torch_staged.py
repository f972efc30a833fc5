"""The port's nonuniform pipeline parallelism (pp > 1) against the JAX
package on the CPU, at the reference's test size (d_model 64, 4 kv-groups,
4 layers), inputs from numpy seeds handed to both packages:

* `configs.shapes` (stage geometry, `candidate_pp`, `SHAPES`) equal;
* `StagedPlan` algebra equal on hypothesis-drawn plans at pp 2 and 4;
* staged `pack_params` / `unpack_params` / `repack_params` bit for bit;
* `transition_staged_trees` trees and `TransferStats` ledgers bit for bit
  through random stage-addressed fail/repair chains, zero bytes for the
  stages an event does not touch, and no tensor held by two trees;
* `bucket_layout` and `sync_collectives` equal;
* `perf_model` equal (exactly) on a sweep;
* the staged step, sequential and overlapped, at microbatches 1 and 2,
  against the reference's dense `make_reference_loss` + `jax.grad` (loss
  and canonical params within 1e-4 after 6 SGD steps);
* a pp=1 `StagedPlan` session bit-identical to the plain one;
* the launcher's ``--pp`` flags;
* one parity test: the reference's pp=2 session (microbatches 2) through
  the chain of tests/dist/session_pp_lifecycle.py on 8 fake devices, in a
  subprocess (``XLA_FLAGS`` must be set before jax is imported), against
  the port's CPU session held to its dense reference;
* the pp=2 trace `chip_smoke.py` replays, pinned event by event.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import shapes as jshapes
from repro.core import failure_model as jfm
from repro.core import nonuniform as jnu
from repro.core import ntp_train as jnt
from repro.core import overlap as jov
from repro.core import perf_model as jpm
from repro.reshard import transition as jtransition
from repro.runtime import orchestrator as jor
from repro_torch import tree as tr
from repro_torch.cluster import GreedyAllocator
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import ntp_params_from_jax
from repro_torch.core import failure_model as tfm
from repro_torch.core import nonuniform as tnu
from repro_torch.core import ntp_train as tnt
from repro_torch.core import overlap as tov
from repro_torch.core import perf_model as tpm
from repro_torch.optim import AdamWConfig, adamw, sgd
from repro_torch.reshard import transition as ttransition
from repro_torch.runtime import (
    FailureEvent, NTPSession, RecoveryEvent, ScheduledEvent, StagedHealth,
    StagedPlan, TraceRunner,
)
from repro_torch.runtime import events as tev
from repro_torch.runtime import orchestrator as tor

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, vocab=128)
LR, LB, SEQ = 0.05, 4, 32

# the chain of tests/dist/session_pp_lifecycle.py (stage-addressed)
CHAIN = {2: ("fail", 1, 0), 5: ("fail", 0, 0), 8: ("repair", 1, 0),
         11: ("repair", 0, 0)}
CHAIN_STEPS = 14

# the pp=2 trace chip_smoke.py replays (2 replicas x 2 stages x TP 4)
CHIP_TRACE_PP = dict(n_gpus=16, domain_size=4, days=16 / 1.0 / 24.0,
                     rate_multiplier=100.0, seed=136,
                     straggler_rate_mult=2.0, link_rate_mult=2.0,
                     sdc_rate_mult=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    eight, and keeps this module's torch work from spinning against the
    other test workers' threads on a shared CPU. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(n_layers=4, **kw):
    kw = dict(KW, **kw)
    return (jnt.NTPModelConfig(n_layers=n_layers, **kw),
            tnt.NTPModelConfig(n_layers=n_layers, **kw))


def _canon(jcfg, seed=0):
    canon_j = jnt.init_canonical(jcfg, jax.random.PRNGKey(seed))
    return canon_j, ntp_params_from_jax(jax.tree.map(np.asarray, canon_j),
                                        device="cpu")


def _plans(stage_tps, n1=4):
    """(port, reference) StagedPlans of per-stage replica TPs."""
    return (tnu.StagedPlan(tuple(tnu.FailurePlan(n1, t) for t in stage_tps)),
            jnu.StagedPlan(tuple(jnu.FailurePlan(n1, t) for t in stage_tps)))


def _bit_equal(ttree, jtree):
    tl, jl = tr.leaves(ttree), jax.tree.leaves(jtree)
    return len(tl) == len(jl) and all(
        np.array_equal(a.detach().numpy(), np.asarray(b))
        for a, b in zip(tl, jl))


def _max_err(ttree, jtree):
    tl, jl = tr.leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    return max(float(np.max(np.abs(a.detach().numpy() - np.asarray(b))))
               for a, b in zip(tl, jl))


# ------------------------------------------------------------------ shapes

@pytest.mark.parametrize("n_layers", [1, 2, 3, 4, 7, 8, 28, 33])
def test_stage_geometry_matches_reference(n_layers):
    for pp in range(0, n_layers + 3):
        try:
            want = (jshapes.stage_boundaries(n_layers, pp),
                    jshapes.layer_stages(n_layers, pp))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                tshapes.stage_boundaries(n_layers, pp)
            continue
        assert (tshapes.stage_boundaries(n_layers, pp),
                tshapes.layer_stages(n_layers, pp)) == want
    for max_pp in (1, 2, 3, 8, 32, 64):
        assert tshapes.candidate_pp(n_layers, max_pp) == \
            jshapes.candidate_pp(n_layers, max_pp)
    assert tshapes.candidate_pp(n_layers) == jshapes.candidate_pp(n_layers)


def test_shape_specs_match_reference():
    assert tshapes.SUPPORTED_PP == jshapes.SUPPORTED_PP
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    for name in jshapes.SHAPES:
        assert dataclasses.astuple(tshapes.get_shape(name)) == \
            dataclasses.astuple(jshapes.get_shape(name))
    with pytest.raises(KeyError, match="unknown shape"):
        tshapes.get_shape("train_1m")


# ------------------------------------------------------------- StagedPlan

@st.composite
def _staged(draw, pp):
    n1 = draw(st.integers(1, 8))
    d = draw(st.integers(1, 4))
    return n1, [tuple(draw(st.integers(1, n1)) for _ in range(d))
                for _ in range(pp)]


@pytest.mark.parametrize("pp", [2, 4])
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_staged_plan_algebra_matches_reference(pp, data):
    n1, tps = data.draw(_staged(pp))
    tp_, jp_ = _plans(tps, n1)
    assert (tp_.pp, tp_.n1, tp_.d, tp_.healthy, tp_.stage_tp,
            tp_.replica_tp) == (jp_.pp, jp_.n1, jp_.d, jp_.healthy,
                                jp_.stage_tp, jp_.replica_tp)
    assert (tp_.effective.n1, tp_.effective.replica_tp) == \
        (jp_.effective.n1, jp_.effective.replica_tp)
    s = data.draw(st.integers(0, pp - 1))
    new = tuple(data.draw(st.integers(1, n1)) for _ in range(len(tps[0])))
    trep = tp_.replace_stage(s, tnu.FailurePlan(n1, new))
    jrep = jp_.replace_stage(s, jnu.FailurePlan(n1, new))
    assert trep.stage_tp == jrep.stage_tp
    assert trep.replace_stage(s, tp_.stages[s]) == tp_
    with pytest.raises(ValueError, match="stage"):
        tp_.replace_stage(pp, tp_.stages[0])


# ---------------------------------------------------- staged pack / repack

STAGED_PLANS = [((4, 4), (4, 4)), ((4, 4), (3, 4)), ((3, 3), (4, 4)),
                ((2, 4), (3, 3))]


@pytest.mark.parametrize("stage_tps", STAGED_PLANS, ids=str)
def test_staged_pack_unpack_match_reference(stage_tps):
    jcfg, tcfg = _cfgs()
    canon_j, canon_t = _canon(jcfg, seed=1)
    tplan, jplan = _plans(stage_tps)
    tp = tnt.pack_params(tcfg, canon_t, tplan)
    jp = jnt.pack_params(jcfg, canon_j, jplan)
    assert _bit_equal(tp, jp)
    # each layer packs at its own stage's buffer width
    for lp, s in zip(tp["layers"], tshapes.layer_stages(4, 2)):
        wp = tnu.weight_plan(tcfg.k_ff, tplan.stages[s])
        assert lp["A"].shape[1] == 4 * wp.buf
    for r in range(2):
        assert _bit_equal(tnt.unpack_params(tcfg, tp, tplan, r),
                          jnt.unpack_params(jcfg, jp, jplan, r))


@pytest.mark.parametrize("chain", [
    [((4, 4), (4, 4)), ((4, 4), (3, 4)), ((3, 3), (3, 4)), ((4, 4), (4, 4))],
    [((4, 4), (4, 4), (4, 4), (4, 4)), ((4, 4), (4, 4), (2, 4), (4, 4)),
     ((4, 4), (3, 4), (2, 4), (4, 4))],
], ids=["pp2", "pp4"])
def test_staged_repack_matches_reference(chain):
    jcfg, tcfg = _cfgs()
    canon_j, canon_t = _canon(jcfg, seed=2)
    plans = [_plans(c) for c in chain]
    tp = tnt.pack_params(tcfg, canon_t, plans[0][0])
    jp = jnt.pack_params(jcfg, canon_j, plans[0][1])
    for (told, jold), (tnew, jnew) in zip(plans, plans[1:]):
        tp = tnt.repack_params(tcfg, tp, told, tnew)
        jp = jnt.repack_params(jcfg, jp, jold, jnew)
        assert _bit_equal(tp, jp)
    assert _bit_equal(tnt.unpack_params(tcfg, tp, plans[-1][0]), canon_j)


# ------------------------------------------------ stage-local transitions

def _random_chain(seed, pp, n_events):
    """A random stage-addressed fail/repair chain on 2 replicas x TP 4, as
    the port's StagedHealth replans it (failures never kill a replica)."""
    rng = np.random.default_rng(seed)
    health = StagedHealth.pristine(2, 4, pp)
    plans = [tev.staged_plan_from_health(health)]
    while len(plans) <= n_events:
        s, dom = int(rng.integers(pp)), int(rng.integers(2))
        h = health.stages[s]
        if rng.random() < 0.6 and h.failed[dom] < 2:
            ev = FailureEvent(stage=s, domain=dom)
        elif h.failed[dom] > 0:
            ev = RecoveryEvent(stage=s, domain=dom)
        else:
            continue
        health = health.apply(ev)
        plans.append(tev.staged_plan_from_health(health))
    return plans


@pytest.mark.parametrize("seed,pp", [(0, 2), (1, 2), (2, 4), (3, 4)])
@pytest.mark.parametrize("copy_unchanged", [True, False])
def test_transition_staged_trees_match_reference(seed, pp, copy_unchanged):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(10 + seed)
    chain = _random_chain(seed, pp, 6)
    jchain = [jnu.StagedPlan(tuple(jnu.FailurePlan(p.n1, p.replica_tp)
                                   for p in c.stages)) for c in chain]
    canon_j = jnt.init_canonical(jcfg, jax.random.PRNGKey(seed))
    jparams = jnt.pack_params(jcfg, canon_j, jchain[0])
    moment = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
        * (p != 0), jparams)
    jtrees = [jparams, moment]
    ttrees = [ntp_params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
              for t in jtrees]
    for told, tnew, jold, jnew in zip(chain, chain[1:], jchain, jchain[1:]):
        before = [{id(t) for t in tr.leaves(x)} for x in ttrees]
        ttrees, tst = ttransition.transition_staged_trees(
            tcfg, ttrees, told, tnew, copy_unchanged=copy_unchanged)
        jtrees, jst = jtransition.transition_staged_trees(
            jcfg, jtrees, jold, jnew, copy_unchanged=copy_unchanged)
        assert tst.as_dict() == jst.as_dict()
        assert tst.per_pair == {tuple(int(x) for x in k): v
                                for k, v in jst.per_pair.items()}
        for t, j in zip(ttrees, jtrees):
            assert _bit_equal(t, j)
        changed = {s for s in range(pp) if told.stages[s] != tnew.stages[s]}
        assert {k[0] for k in tst.per_pair} <= changed
        # every stage the event does not touch moves zero bytes, and no
        # tensor is held by two trees after the move
        ids = [id(t) for x in ttrees for t in tr.leaves(x)]
        assert len(ids) == len(set(ids))
        kept = set(ids) & set().union(*before)
        bounds = tshapes.stage_boundaries(tcfg.n_layers, pp)
        untouched = {id(t) for x in ttrees for s in range(pp)
                     if s not in changed
                     for lp in x["layers"][bounds[s]:bounds[s + 1]]
                     for t in tr.leaves(lp)}
        top = {id(x[k]) for x in ttrees for k in ("embed", "head",
                                                  "final_norm")}
        assert kept == (untouched | top if not copy_unchanged else set())


# --------------------------------------------------- bucketed sync counts

@pytest.mark.parametrize("n_layers,stage_tps", [
    (4, ((4, 4), (3, 4))), (4, ((4, 4), (4, 4))), (6, ((3, 4), (4, 4))),
    (8, ((4, 4), (2, 4), (4, 4), (3, 3))), (5, ((4, 4), (4, 3))),
], ids=str)
@pytest.mark.parametrize("mode", ["ntp", "uniform", "dpdrop"])
def test_bucket_layout_and_collectives_match_reference(n_layers, stage_tps,
                                                       mode):
    jcfg, tcfg = _cfgs(n_layers)
    tplan, jplan = _plans(stage_tps)
    for chunks in (None, tov.chunk_ranges(n_layers, tplan.pp)):
        assert tov.chunk_ranges(n_layers, tplan.pp) == \
            jov.chunk_ranges(n_layers, jplan.pp)
        tb = tov.bucket_layout(tcfg, tplan, chunks)
        jb = jov.bucket_layout(jcfg, jplan, chunks)
        assert [dataclasses.astuple(b) for b in tb] == \
            [dataclasses.astuple(b) for b in jb]
        for bucketed in (False, True):
            assert tov.sync_collectives(tcfg, tplan, mode, bucketed=bucketed,
                                        chunks=chunks) == \
                jov.sync_collectives(jcfg, jplan, jnt.Mode.coerce(mode),
                                     bucketed=bucketed, chunks=chunks)
    with pytest.raises(ValueError, match="straddles"):
        tov.bucket_layout(tcfg, tplan, ((0, n_layers),))


# -------------------------------------------------------------- perf_model

HW = [jpm.Hardware(), jpm.Hardware(domain_size=4, chip_flops=989e12,
                                   hbm_bw=3.35e12, scaleup_bw=4.5e11)]
WL = [jpm.Workload(), jpm.Workload(n_params=7.6e9, n_layers=28,
                                   d_model=3584, seq_len=4096,
                                   minibatch_tokens=4e6)]


def _pm(pkg, hw, wl):
    """The same Hardware/Workload in ``pkg``."""
    return (pkg.Hardware(**dataclasses.asdict(hw)),
            pkg.Workload(**dataclasses.asdict(wl)))


@pytest.mark.parametrize("hi", range(len(HW)))
@pytest.mark.parametrize("wi", range(len(WL)))
def test_perf_model_matches_reference(hi, wi):
    jhw, jwl = HW[hi], WL[wi]
    thw, twl = _pm(tpm, jhw, jwl)
    tp_full = jhw.domain_size
    for tp, pp, dp, mbs in ((tp_full, 4, 16, 1), (tp_full, 1, 8, 2),
                            (max(1, tp_full // 2), 2, 32, 1)):
        jpar = jpm.Parallel(tp=tp, pp=pp, dp=dp, microbatch_seqs=mbs)
        tpar = tpm.Parallel(tp=tp, pp=pp, dp=dp, microbatch_seqs=mbs)
        assert tpar.gpus == jpar.gpus
        for kw in ({}, {"tp_reduced": max(1, tp - 1)},
                   {"local_batch_scale": 0.75, "power_speedup": 1.2},
                   {"reshard_overlap": 0.5, "tp_reduced": max(1, tp - 1)},
                   {"slow_factor": 1.4, "link_bw_frac": 0.35},
                   {"dp_overlap": 0.0, "tp_overlap": 0.9}):
            assert tpm.iteration_time(thw, twl, tpar, **kw) == \
                jpm.iteration_time(jhw, jwl, jpar, **kw)
            okw = {k: v for k, v in kw.items()
                   if k not in ("dp_overlap", "reshard_overlap")}
            for frac, ratio in ((0.7, 1.0), (0.0, 0.5), (1.0, 2.0)):
                assert tpm.overlap_iteration_time(
                    thw, twl, tpar, overlappable_fraction=frac,
                    collective_ratio=ratio, **okw) == \
                    jpm.overlap_iteration_time(
                        jhw, jwl, jpar, overlappable_fraction=frac,
                        collective_ratio=ratio, **okw)
        for stage_tps in itertools.product(range(max(1, tp - 1), tp + 1),
                                           repeat=pp):
            assert tpm.staged_iteration_time(thw, twl, tpar, stage_tps) == \
                jpm.staged_iteration_time(jhw, jwl, jpar, stage_tps)
    for n_gpus, kw in ((1024, {}), (4096, {"tp_limit": 2}),
                       (512, {"min_pp": 2}), (3, {})):
        assert tpm.best_config(thw, twl, n_gpus, **kw) == \
            jpm.best_config(jhw, jwl, n_gpus, **kw)
    assert tpm.exposed_comm(0.3, 0.2) == jpm.exposed_comm(0.3, 0.2)
    assert tpm.exposed_comm(0.1, 0.2) == 0.0
    with pytest.raises(ValueError, match="slow_factor"):
        tpm.iteration_time(thw, twl, tpm.Parallel(), slow_factor=0.5)
    with pytest.raises(ValueError, match="stage TPs"):
        tpm.staged_iteration_time(thw, twl, tpm.Parallel(pp=2), (1,))


# ---------------------------------------------- staged step vs dense ref

STEP_CASES = [(((4, 4), (4, 3)), "ntp", overlap, mb)
              for overlap in (False, True) for mb in (1, 2)] + [
    (((3, 3), (4, 4)), "ntp", False, 2), (((3, 3), (4, 4)), "ntp", True, 1),
    (((4, 4), (3, 4)), "dpdrop", False, 2),
    (((4, 4), (3, 4)), "dpdrop", True, 1)]
_REF_GRAD = {}


def _ref_grad(jcfg):
    """The reference's jitted dense loss and grad, once per config."""
    if jcfg not in _REF_GRAD:
        _REF_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            jnt.make_reference_loss(jcfg)))
    return _REF_GRAD[jcfg]


@pytest.mark.parametrize("stage_tps,mode,overlap,microbatches", STEP_CASES,
                         ids=str)
def test_staged_step_matches_dense_reference(stage_tps, mode, overlap,
                                             microbatches):
    jcfg, tcfg = _cfgs()
    canon_j, canon_t = _canon(jcfg)
    tplan, jplan = _plans(stage_tps)
    step = tnt.make_ntp_train_step(tcfg, tplan, (2, 4), mode=mode,
                                   local_batch=LB, optimizer=sgd(LR),
                                   microbatches=microbatches, overlap=overlap)
    assert step.overlap is overlap
    assert step.collectives == jov.sync_collectives(
        jcfg, jplan, jnt.Mode.coerce(mode), bucketed=overlap,
        chunks=jov.chunk_ranges(4, 2) if overlap else None)
    packed = tnt.pack_params(tcfg, canon_t, tplan)
    opt = sgd(LR).init(packed)
    lb = jnt.default_local_batches(jplan, jnt.Mode.coerce(mode), LB)
    assert list(lb) == list(tnt.default_local_batches(tplan, mode, LB))
    mask = jnp.asarray(np.concatenate(
        [(np.arange(LB) < lb[d]).astype(np.float32) for d in range(2)]))
    ref_grad = _ref_grad(jcfg)
    ref = canon_j
    rng = np.random.default_rng(0)
    for i in range(6):
        tokens = rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
        packed, opt, m = step(packed, opt, tokens.astype(np.int32))
        rl, g = ref_grad(ref, jnp.asarray(tokens), mask)
        ref = jax.tree.map(lambda p, gg: p - LR * gg, ref, g)
        assert abs(float(m["loss"]) - float(rl)) < 1e-4, i
    for r in (range(2) if mode == "ntp" else (1,)):
        assert _max_err(tnt.unpack_params(tcfg, packed, tplan, r), ref) < 1e-4


def test_microbatches_are_validated():
    _, tcfg = _cfgs()
    tplan, _ = _plans(((4, 4), (4, 4)))
    for overlap in (False, True):
        with pytest.raises(ValueError, match="outside"):
            tnt.make_ntp_train_step(tcfg, tplan, local_batch=4,
                                    microbatches=5, overlap=overlap)
        with pytest.raises(ValueError, match="not divisible"):
            tnt.make_ntp_train_step(tcfg, tplan, local_batch=4,
                                    microbatches=3, overlap=overlap)
    with pytest.raises(ValueError, match="does not fit mesh"):
        tnt.make_ntp_train_step(tcfg, tplan, (2, 8))


# ------------------------------------------------------- staged sessions

def _run(session, steps, events=None):
    pipe = np.random.default_rng(0)
    losses = []
    for i in range(steps):
        if events and i in events:
            session.apply(events[i])
        tokens = pipe.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
        losses.append(session.step(tokens)["loss"])
    return losses


@pytest.mark.parametrize("overlap", [False, True])
def test_pp1_staged_session_is_bit_identical(overlap):
    """A pp=1 StagedPlan / StagedHealth seed is unwrapped: the session is
    the plain one, bit for bit, through fail→repair with AdamW."""
    _, tcfg = _cfgs()
    canon = tnt.init_canonical(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    events = {2: FailureEvent(replica=1), 4: RecoveryEvent(replica=0)}
    kw = dict(local_batch=LB, params=canon, overlap=overlap, device="cpu",
              optimizer=adamw(AdamWConfig(lr=1e-2)))
    plain = NTPSession.create(tcfg, (2, 4), **kw)
    seeds = [dict(plan=StagedPlan((tnu.FailurePlan(4, (4, 4)),))),
             dict(health=StagedHealth.pristine(2, 4, 1))]
    runs = [NTPSession.create(tcfg, (2, 4), **kw, **s) for s in seeds]
    want = _run(plain, 6, events)
    for s in runs:
        assert s.pp == 1 and isinstance(s.plan, tnu.FailurePlan)
        got = _run(s, 6, events)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(
            tr.leaves(s.params), tr.leaves(plain.params)))
        assert all(torch.equal(a, b) for a, b in zip(
            tr.leaves(s.opt_state), tr.leaves(plain.opt_state)))


def test_staged_session_seeding_and_refusals():
    _, tcfg = _cfgs()
    plan = tnu.StagedPlan((tnu.FailurePlan(4, (4, 4)),
                           tnu.FailurePlan(4, (3, 4))))
    s = NTPSession.create(tcfg, (2, 4), plan=plan, device="cpu")
    assert s.pp == 2 and s.plan == plan and s.stage_boundaries == (0, 2, 4)
    assert s.local_batches == [3, 4]
    for kw, match in (
            (dict(pp=2, plan=tnu.FailurePlan(4, (4, 4))), "needs a staged"),
            (dict(pp=2, health=tev.ClusterHealth.pristine(2, 4)),
             "needs a staged"),
            (dict(pp=4, plan=plan), "has 2 stages"),
            (dict(plan=tnu.StagedPlan((tnu.FailurePlan(4, (4, 3)),) * 2)),
             "per-stage packed order"),
            (dict(pp=2, spares=1), "global allocator"),
            (dict(pp=0), "pp must be"),
            (dict(pp=2, microbatches=3), "not divisible")):
        with pytest.raises(ValueError, match=match):
            NTPSession.create(tcfg, (2, 4), device="cpu", **kw)
    with pytest.raises(ValueError, match="pp>1 global repack planner"):
        NTPSession.create(tcfg, (2, 4), pp=1, plan=plan,
                          allocator=GreedyAllocator(), device="cpu")
    s = NTPSession.create(tcfg, (2, 4), pp=2, spares=1,
                          allocator=GreedyAllocator(), device="cpu")
    assert s.plan.healthy and s.last_global_plan is not None


def test_staged_runner_rejects_dead_replicas_and_absorbs_their_repairs():
    """Stage-addressed events through `TraceRunner(verify=True)`: a failure
    that would leave stage 1 of a replica without GPUs is rejected, its
    repair is absorbed against the (stage, domain) debt while a real
    failure of that site stands, the next repair heals it, and a later
    failure lands on stage 0 only — each checked against the dense
    reference."""
    _, tcfg = _cfgs()
    s = NTPSession.create(tcfg, (2, 4), local_batch=LB, optimizer=sgd(LR),
                          device="cpu", pp=2,
                          generator=torch.Generator().manual_seed(0))
    sched = [ScheduledEvent(0, FailureEvent(step=0, stage=1, domain=0,
                                            n_gpus=4)),
             ScheduledEvent(1, FailureEvent(step=1, stage=1, domain=0)),
             ScheduledEvent(2, RecoveryEvent(step=2, stage=1, domain=0,
                                             n_gpus=4)),
             ScheduledEvent(3, RecoveryEvent(step=3, stage=1, domain=0,
                                             n_gpus=1)),
             ScheduledEvent(4, FailureEvent(step=4, stage=0, domain=1))]
    runner = TraceRunner(s, sched, verify=True)
    rng = np.random.default_rng(0)
    hist = runner.run(
        lambda i: rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1)), 6)
    assert [t["kind"] for t in runner.transitions] == \
        ["rejected", "failure", "absorbed", "repair", "failure"]
    assert [h["stage_tp"] for h in hist] == (
        [((4, 4), (4, 4))] + [((4, 3), (4, 4))] * 2 + [((4, 4), (4, 4))]
        + [((3, 4), (4, 4))] * 2)
    summ = runner.summary()
    assert (summ["rejected"], summ["absorbed_repairs"], summ["failures"],
            summ["repairs"]) == (1, 1, 2, 1)


def test_staged_session_checkpoint_snapshot_and_sync(tmp_path):
    """save/restore, snapshot/rollback and measure_sync under a staged plan,
    through the canonical layout: a checkpoint written at one staged plan
    restores bit-identically into a session at another."""
    _, tcfg = _cfgs()
    kw = dict(local_batch=LB, device="cpu", pp=2, microbatches=2,
              optimizer=adamw(AdamWConfig(lr=1e-2)),
              generator=torch.Generator().manual_seed(0))
    s = NTPSession.create(tcfg, (2, 4), **kw)
    _run(s, 3, {1: FailureEvent(stage=1, domain=0)})
    s.snapshot()
    snap = s.canonical_params()
    path = str(tmp_path / "ck.npz")
    s.save(path)
    _run(s, 2, {0: FailureEvent(stage=0, domain=1)})
    assert s.plan.stage_tp == ((3, 3), (4, 4))
    step = s.rollback()
    assert step == 3 and all(torch.equal(a, b) for a, b in zip(
        tr.leaves(s.canonical_params()), tr.leaves(snap)))
    fresh = NTPSession.create(
        tcfg, (2, 4), plan=tnu.StagedPlan((tnu.FailurePlan(4, (3, 4)),
                                           tnu.FailurePlan(4, (4, 4)))),
        **dict(kw, generator=torch.Generator().manual_seed(5)))
    assert fresh.restore(path) == 3
    for r in range(2):
        assert all(torch.equal(a, b) for a, b in zip(
            tr.leaves(fresh.canonical_params(r)), tr.leaves(snap)))
    sync = s.measure_sync(np.zeros((2 * LB, SEQ + 1), np.int64))
    assert sync["collectives"] == s.step_fn.collectives
    assert sync["overlap"] == "off" and sync["sync_s"] >= 0


# ------------------------------------------------------------- launcher

def test_launcher_pp_cpu_smoke(capsys):
    from repro_torch.launch.train import main

    out = main(["--ntp", "--device", "cpu", "--pp", "2", "--microbatches",
                "2", "--steps", "4", "--fail-at", "2", "--fail-stage", "1",
                "--seq-len", "16", "--batch", "2", "--overlap", "on",
                "--log-every", "1"])
    text = capsys.readouterr().out
    assert "pp=2 stages (0, 2, 4)" in text
    assert "*** step 2: FailureEvent(replica=1, stage=1, n_gpus=1) -> plan " \
        "StagedPlan(" in text
    assert "stage_rel (" in text
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["plan"].stage_tp == ((4, 3), (4, 4))


def test_launcher_pp_trace_cpu_smoke(capsys):
    """--pp 2 with --trace and no --ckpt: the trace's domains are the
    (replica, stage) grid, and every event names its stage."""
    from repro_torch.launch.train import main

    out = main(["--ntp", "--device", "cpu", "--pp", "2", "--steps", "6",
                "--trace", "200", "--trace-seed", "136", "--seq-len", "16",
                "--batch", "2", "--log-every", "3"])
    text = capsys.readouterr().out
    assert "trace: " in text and " stage 0 domain " in text
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("argv,match", [
    (["--pp", "3"], "not in supported ladder"),
    (["--fail-stage", "1"], "--fail-stage needs --pp > 1"),
    (["--allocator", "greedy"], "pp=1 sessions already pack globally"),
    (["--pp", "2", "--spares", "1"], "pass --allocator greedy"),
    (["--allocator", "greedy", "--spares", "1"],
     "pp=1 sessions already pack globally"),
])
def test_launcher_pp_flag_errors(argv, match, capsys):
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit):
        main(["--ntp", "--device", "cpu", *argv])
    assert match in capsys.readouterr().err


# ------------------------------------------ the chip's pp=2 trace, pinned

def _sched(schedule):
    return [(e.step, type(e.event).__name__,
             {k: v for k, v in dataclasses.asdict(e.event).items()})
            for e in schedule]


def test_chip_pp2_schedule_is_pinned():
    """The 16-step pp=2 schedule chip_smoke.py replays: a failure and its
    repair, a link degrade and its repair, an SDC suspicion (rolled back to
    the step-0 snapshot) and a straggler with their clears, each on one
    stage — the same in both packages."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TRACE_PP == CHIP_TRACE_PP
    got = tor.schedule_from_trace(tfm.FailureTraceConfig(**CHIP_TRACE_PP),
                                  steps=16, steps_per_hour=1.0, pp=2)
    want = jor.schedule_from_trace(jfm.FailureTraceConfig(**CHIP_TRACE_PP),
                                   steps=16, steps_per_hour=1.0, pp=2)
    assert _sched(got) == _sched(want)
    assert [(s, k, e["stage"], e["domain"]) for s, k, e in _sched(got)] == [
        (0, "FailureEvent", 0, 1), (5, "LinkDegradeEvent", 1, 0),
        (7, "LinkRepairEvent", 1, 0), (8, "RecoveryEvent", 0, 1),
        (10, "SdcSuspectEvent", 0, 1), (11, "SdcClearEvent", 0, 1),
        (12, "StragglerEvent", 1, 1), (15, "StragglerClearEvent", 1, 1)]


# --------------------------------------- parity with the JAX pp=2 session

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import ntp_train as nt
from repro.optim import sgd
from repro.runtime import FailureEvent, NTPSession, RecoveryEvent

out_path, (KW, LB, SEQ, STEPS, CHAIN, LR) = sys.argv[1], eval(sys.argv[2])
cfg = nt.NTPModelConfig(n_layers=4, **KW)
mesh = jax.make_mesh((2, 4), ("data", "model"))
canon = nt.init_canonical(cfg, jax.random.PRNGKey(0))
s = NTPSession.create(cfg, mesh, local_batch=LB, optimizer=sgd(LR),
                      params=canon, pp=2)


def place():
    # the packed trees where the step's outputs live: each plan's step then
    # compiles once, not once for host arrays and again for its outputs
    specs = nt._tree_specs(s._params)
    s._params = jax.device_put(
        s._params, jax.tree.map(lambda p: NamedSharding(mesh, p), specs))
    s._opt = jax.device_put(s._opt, NamedSharding(mesh, P()))


place()
rng = np.random.default_rng(0)
hist, ledgers = [], []
for i in range(STEPS):
    if i in CHAIN:
        kind, stage, domain = CHAIN[i]
        cls = FailureEvent if kind == "fail" else RecoveryEvent
        s.apply(cls(step=i, stage=stage, domain=domain))
        place()
        st = s.last_transition
        ledgers.append({"stats": st.as_dict(), "per_pair": sorted(
            [[int(x) for x in k], v] for k, v in st.per_pair.items())})
    tokens = rng.integers(0, cfg.vocab, (2 * LB, SEQ + 1))
    m = s.step(jnp.asarray(tokens))
    hist.append({"loss": float(m["loss"]),
                 "stage_tp": [list(t) for t in s.plan.stage_tp],
                 "local_batches": [int(b) for b in s.local_batches],
                 "stage_rel_iter_time": list(m["stage_rel_iter_time"]),
                 "rel_iter_time": m["rel_iter_time"],
                 "collectives": int(s._step_fn.collectives)})
arrays = {"canonical/" + str(i): np.asarray(x)
          for i, x in enumerate(jax.tree.leaves(canon))}
for r in range(2):
    for i, x in enumerate(jax.tree.leaves(s.canonical_params(r))):
        arrays[f"end{r}/{i}"] = np.asarray(x)
arrays["meta"] = np.asarray(json.dumps({"history": hist,
                                        "ledgers": ledgers}))
np.savez(out_path, **arrays)
"""


def _leaves_of(res, prefix):
    keys = sorted((k for k in res.files if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [res[k] for k in keys]


def test_pp2_session_matches_jax_session_on_fake_mesh(tmp_path):
    """The port's pp=2, microbatches=2 session against
    the JAX package's pp=2 session on 2×4 fake CPU devices (microbatches 1:
    the host-side records do not depend on them, the loss only up to the
    order of f32 sums, and each microbatch compiles the reference's step
    larger), through the stage-addressed chain of
    tests/dist/session_pp_lifecycle.py with SGD: per-step
    stage_tp, local_batches, stage_rel_iter_time, rel_iter_time and
    step.collectives equal, losses within 1e-4, transition ledgers equal
    bit for bit and each naming exactly the hit stage, canonical params
    within 1e-4 of the JAX session's; the port's run is held to its dense
    reference (loss and canonical params within 1e-4) by
    `TraceRunner(verify=True)` at every step and transition."""
    path = str(tmp_path / "jax_pp.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, path,
         repr((KW, LB, SEQ, CHAIN_STEPS, CHAIN, LR))],
        capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = np.load(path)
    meta = json.loads(str(res["meta"]))

    _, tcfg = _cfgs()
    like = tnt.init_canonical(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    numpy_tree = tr.tree_map(lambda t: None, like)
    for p, v in zip([p for p, _ in tr.leaves_with_path(like)],
                    _leaves_of(res, "canonical")):
        tr.set_path(numpy_tree, p, v)
    sched = [ScheduledEvent(i, (FailureEvent if kind == "fail" else
                                RecoveryEvent)(step=i, stage=s, domain=d))
             for i, (kind, s, d) in CHAIN.items()]
    sess = NTPSession.create(
        tcfg, (2, 4), local_batch=LB, optimizer=sgd(LR), device="cpu",
        params=ntp_params_from_jax(numpy_tree, device="cpu"), pp=2,
        microbatches=2)
    ledgers, colls = [], []

    def on_event(ev, plan):
        st = sess.last_transition
        assert {k[0] for k in st.per_pair} == {ev.stage}
        ledgers.append({"stats": st.as_dict(), "per_pair": sorted(
            [list(k), v] for k, v in st.per_pair.items())})

    real = sess.step

    def step(batch):
        colls.append(sess.step_fn.collectives)
        return real(batch)

    sess.step = step
    runner = TraceRunner(sess, sched, verify=True, atol=1e-4,
                         on_event=on_event)
    rng = np.random.default_rng(0)
    hist = runner.run(
        lambda i: rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1)),
        CHAIN_STEPS)
    assert ledgers == meta["ledgers"]
    for h, j, c in zip(hist, meta["history"], colls):
        assert [list(t) for t in h["stage_tp"]] == j["stage_tp"]
        assert list(h["local_batches"]) == j["local_batches"]
        assert list(h["stage_rel_iter_time"]) == j["stage_rel_iter_time"]
        assert h["rel_iter_time"] == j["rel_iter_time"] == \
            max(j["stage_rel_iter_time"])
        assert abs(h["loss"] - j["loss"]) < 1e-4, h["step"]
        assert c == j["collectives"]
    for rep in range(2):
        got = tr.leaves(sess.canonical_params(rep))
        want = _leaves_of(res, f"end{rep}")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.max(np.abs(a.numpy() - b)) < 1e-4


def test_pp2_overlap_on_and_off_agree_in_lockstep():
    """Overlap on and off (microbatches 2), in lockstep through the chain:
    losses within 1e-5 and canonical params within 1e-4 at every step,
    fewer collectives with overlap on at every plan (as
    tests/dist/session_overlap_pp.py holds the reference)."""
    _, tcfg = _cfgs()
    canon = tnt.init_canonical(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    kw = dict(local_batch=LB, optimizer=sgd(LR), device="cpu", pp=2,
              microbatches=2, params=canon)
    off = NTPSession.create(tcfg, (2, 4), overlap=False, **kw)
    on = NTPSession.create(tcfg, (2, 4), overlap=True, **kw)
    rng = np.random.default_rng(0)
    for i in range(CHAIN_STEPS):
        if i in CHAIN:
            kind, s, d = CHAIN[i]
            ev = (FailureEvent if kind == "fail" else RecoveryEvent)(
                step=i, stage=s, domain=d)
            off.apply(ev)
            on.apply(ev)
            assert on.last_transition.as_dict() == \
                off.last_transition.as_dict()
        assert on.step_fn.collectives < off.step_fn.collectives
        tokens = rng.integers(0, KW["vocab"], (2 * LB, SEQ + 1))
        l_off, l_on = float(off.step(tokens)["loss"]), \
            float(on.step(tokens)["loss"])
        assert abs(l_off - l_on) < 1e-5, i
        for a, b in zip(tr.leaves(off.canonical_params()),
                        tr.leaves(on.canonical_params())):
            assert float((a - b).abs().max()) < 1e-4
    assert off.plan.healthy and on.plan.healthy
