"""The port's global repack planner (`repro_torch.cluster`) and
`resource_manager.packing_stats` against the JAX package, on the host (no
mesh):

* the reference's `SWEEP` and its four properties (conservation,
  amortized, zero-horizon, deterministic) on the port's allocator, and the
  properties again on hypothesis layouts drawn with the reference's
  `_layouts()` strategy, unnarrowed. The port keeps the reference's search
  as it is, so its conservation property fails on the input the
  reference's fails on (``n1=2, counts ((0,1,1),(2,0,0)), spares=1``: a
  swap refills the site the spare zeroed); that input is an explicit
  example of the port's copy, which is expected to fail;
* parity: the port's `GlobalPlan` equals the reference's field for field
  (counts, spare sites, swaps, goodputs, the staged plans, each action's
  kind, site, bytes, cost/gain to 1e-12 and order) on the sweep, on
  hypothesis layouts, on degradation ledgers, and on the falsifying layout;
* `TransitionCostModel.from_trees` on the port's packed trees equal to the
  reference's on the JAX trees packed from the same canonical params
  (dense, and a reduced MoE config with the `expert` family), and
  `from_rank_trees` on every process's slots equal to both;
* `predict` equal to the executed `transition_staged_trees` ledger on the
  reference's three (old, new) pairs;
* `packing_stats`, `GoodputModel.for_perf`, `analytic` and the
  degradation-weighted goodput equal to the reference's.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

from repro import cluster as jcl
from repro.core import ntp_train as jnt
from repro.core import nonuniform as jnu
from repro.core import perf_model as jpm
from repro.core import resource_manager as jrm
from repro.runtime import events as jev
from repro_torch import cluster as tcl
from repro_torch import tree as tr
from repro_torch.convert import ntp_params_from_jax
from repro_torch.core import ntp_train as tnt
from repro_torch.core import nonuniform as tnu
from repro_torch.core import perf_model as tpm
from repro_torch.core import resource_manager as trm
from repro_torch.reshard.transition import transition_staged_trees
from repro_torch.runtime import events as tev


def _load_reference_tests():
    """tests/test_cluster_allocator.py as a module of its own (its SWEEP,
    its `_layouts()` strategy and its property checks)."""
    path = os.path.join(os.path.dirname(__file__), "test_cluster_allocator.py")
    spec = importlib.util.spec_from_file_location("_ref_cluster_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference_tests()
SWEEP = REF.SWEEP
FALSIFYING = (2, ((0, 1, 1), (2, 0, 0)), 1)


def health_of(n1, counts, degraded=None, ev=tev):
    """A `StagedHealth` of ``ev`` (the port's events module or the
    reference's) from per-stage counts and optional per-stage degradation
    tuples ((straggle, link, sdc) or None per domain)."""
    stages = []
    for s, c in enumerate(counts):
        degs = None
        if degraded is not None and degraded[s] is not None:
            degs = tuple(None if d is None else ev.DomainDegradation(*d)
                         for d in degraded[s])
            if all(d is None for d in degs):
                degs = None
        stages.append(ev.ClusterHealth(n1, tuple(int(x) for x in c),
                                       degraded=degs))
    return ev.StagedHealth(tuple(stages))


def synthetic_cost(pp, cl=tcl, n_layers=4):
    """The reference's `synthetic_cost`, in either package."""
    return cl.TransitionCostModel(family_layer_bytes={8: 4096, 16: 1024},
                                  n_layers=n_layers, pp=pp)


def _plan_or_none(alloc, h, **kw):
    try:
        return alloc.plan(h, **kw)
    except (tev.DeadReplicaError, jev.DeadReplicaError):
        return None


# ---------------------------------------------------------------------------
# the reference's properties on the port's allocator

def check_conservation(n1, counts, spares):
    h = health_of(n1, counts)
    gp = _plan_or_none(tcl.GreedyAllocator(), h, spares=spares)
    if gp is None:
        return
    final = [list(c) for c in gp.counts]
    assert len(gp.spare_sites) <= spares
    for s, d, absorbed in gp.spare_sites:
        assert final[s][d] == 0, "a spare must zero the site it covers"
        final[s][d] = absorbed
    assert sorted(x for c in final for x in c) == \
        sorted(x for c in counts for x in c), (counts, gp.counts,
                                               gp.spare_sites)
    for c, fp in zip(gp.counts, gp.staged_plan.stages):
        assert sorted(fp.replica_tp) == sorted(n1 - x for x in c)


def check_amortized(n1, counts, spares):
    pp = len(counts)
    cost = synthetic_cost(pp)
    current = tev.staged_plan_from_health(tev.StagedHealth.pristine(
        len(counts[0]), n1, pp=pp))
    alloc = tcl.GreedyAllocator(goodput=tcl.GoodputModel(n1=n1), cost=cost)
    gp = _plan_or_none(alloc, health_of(n1, counts), spares=spares,
                       current=current)
    if gp is None:
        return
    for a in gp.decisions:
        assert a.rescue or a.cost_s <= a.gain_s + 1e-12, a
        assert a.bytes >= 0 and a.cost_s >= 0
    assert gp.predicted_bytes == sum(a.bytes for a in gp.transitions)
    assert gp.predicted_bytes == cost.predict_bytes(current, gp.staged_plan)
    assert gp.goodput >= gp.baseline_goodput - 1e-12


def check_zero_horizon_is_stage_local(n1, counts):
    h = health_of(n1, counts)
    try:
        sl = tev.staged_plan_from_health(h)
    except tev.DeadReplicaError:
        return
    alloc = tcl.GreedyAllocator(tcl.AllocatorConfig(horizon_steps=0),
                                goodput=tcl.GoodputModel(n1=n1),
                                cost=synthetic_cost(len(counts)))
    gp = alloc.plan(h, spares=0, current=sl)
    assert gp.staged_plan == sl, (counts, gp.summary())
    assert gp.predicted_bytes == 0 and not gp.moved


def check_deterministic(n1, counts, spares):
    h = health_of(n1, counts)
    a = _plan_or_none(tcl.GreedyAllocator(), h, spares=spares)
    b = _plan_or_none(tcl.GreedyAllocator(), h, spares=spares)
    assert a == b


@pytest.mark.parametrize("n1,counts,spares", SWEEP)
def test_sweep_properties(n1, counts, spares):
    check_conservation(n1, counts, spares)
    check_amortized(n1, counts, spares)
    check_zero_horizon_is_stage_local(n1, counts)
    check_deterministic(n1, counts, spares)


@settings(max_examples=80, deadline=None)
@given(REF._layouts())
@example(FALSIFYING)
def test_hypothesis_conservation(layout):
    """The reference's conservation property, unnarrowed. Expected to fail
    on `FALSIFYING`, as the reference's does: the port mirrors its search
    (ROADMAP Queue 3)."""
    check_conservation(*layout)


@settings(max_examples=60, deadline=None)
@given(REF._layouts())
def test_hypothesis_amortized(layout):
    check_amortized(*layout)


@settings(max_examples=60, deadline=None)
@given(REF._layouts())
def test_hypothesis_zero_horizon(layout):
    n1, counts, _ = layout
    check_zero_horizon_is_stage_local(n1, counts)


@settings(max_examples=40, deadline=None)
@given(REF._layouts())
def test_hypothesis_deterministic(layout):
    check_deterministic(*layout)


# ---------------------------------------------------------------------------
# parity with the reference's verdicts

def _plan_table(sp):
    return None if sp is None else (sp.n1, tuple(p.replica_tp
                                                 for p in sp.stages))


def _fields(gp):
    """Everything of a `GlobalPlan` but the float action prices, which
    `_assert_parity` holds to 1e-12."""
    return {
        "counts": gp.counts, "spare_sites": gp.spare_sites,
        "swaps": gp.swaps, "goodput": gp.goodput,
        "baseline_goodput": gp.baseline_goodput,
        "staged_plan": _plan_table(gp.staged_plan),
        "baseline": _plan_table(gp.baseline),
        "predicted_bytes": gp.predicted_bytes,
        "horizon_steps": gp.horizon_steps,
        "actions": [(a.kind, a.site, a.other, a.absorbed, a.bytes, a.rescue,
                     a.stage, a.order, a.note) for a in gp.actions],
    }


def _assert_parity(got, want):
    if want is None or got is None:
        assert got is None and want is None, (got, want)
        return
    assert _fields(got) == _fields(want)
    for a, b in zip(got.actions, want.actions):
        assert abs(a.cost_s - b.cost_s) <= 1e-12, (a, b)
        assert abs(a.gain_s - b.gain_s) <= 1e-12, (a, b)
    assert got.summary() == want.summary()


def _both(n1, counts, spares, degraded=None, *, priced=False, horizon=200,
          current="pristine"):
    """(port, reference) verdicts on the same ledger: unpriced, or priced by
    `synthetic_cost` against ``current`` ("pristine" or "stage_local")."""
    pp = len(counts)
    out = []
    for cl, ev, nu in ((tcl, tev, tnu), (jcl, jev, jnu)):
        h = health_of(n1, counts, degraded, ev)
        kw = {}
        if priced:
            base = (ev.StagedHealth.pristine(len(counts[0]), n1, pp=pp)
                    if current == "pristine" else
                    health_of(n1, counts, None, ev))
            try:
                kw["current"] = ev.staged_plan_from_health(base)
            except ev.DeadReplicaError:
                kw["current"] = ev.staged_plan_from_health(
                    ev.StagedHealth.pristine(len(counts[0]), n1, pp=pp))
        alloc = cl.GreedyAllocator(
            cl.AllocatorConfig(horizon_steps=horizon),
            goodput=cl.GoodputModel(n1=n1),
            cost=synthetic_cost(pp, cl) if priced else None)
        out.append(_plan_or_none(alloc, h, spares=spares, **kw))
    return out


def _parity_all_modes(n1, counts, spares, degraded=None):
    _assert_parity(*_both(n1, counts, spares, degraded))
    _assert_parity(*_both(n1, counts, spares, degraded, priced=True))
    _assert_parity(*_both(n1, counts, spares, degraded, priced=True,
                          current="stage_local", horizon=1000))
    _assert_parity(*_both(n1, counts, 0, degraded, priced=True,
                          current="stage_local", horizon=0))


@pytest.mark.parametrize("n1,counts,spares", SWEEP + [FALSIFYING])
def test_verdicts_match_reference_on_sweep(n1, counts, spares):
    _parity_all_modes(n1, counts, spares)


def test_falsifying_layout_reproduces_reference_verdict():
    """The port's verdict on the reference's falsifying layout equals the
    reference's: the spare lands on (1, 0, 2), then the swap of stage 0
    domain 1 with stage 1 domain 0 refills that site."""
    n1, counts, spares = FALSIFYING
    got, want = _both(n1, counts, spares)
    _assert_parity(got, want)
    assert got.spare_sites == ((1, 0, 2),)
    assert got.swaps == (((0, 1), (1, 0)),)
    assert got.counts == ((0, 0, 1), (1, 0, 0))


@settings(max_examples=40, deadline=None)
@given(REF._layouts())
def test_hypothesis_verdicts_match_reference(layout):
    _parity_all_modes(*layout)


DEGRADED = [
    # a straggler in a clear domain, spared out
    (4, ((0, 0), (0, 0)), 1, (((2.0,), (), 0), None), (None, None)),
    # a weak link beside a failure
    (4, ((1, 0), (0, 0)), 0, (None, ((), (0.5,), 0)), (None, None)),
    # an SDC suspicion on one stage, a failure on the other
    (4, ((0, 1), (1, 0)), 1, (((), (), 1), None), (None, None)),
    # stragglers on both stages of a pp=3 job
    (2, ((1, 0, 1), (0, 1, 0), (1, 1, 0)), 1,
     (None, ((1.5,), (), 0), None), (((3.0,), (0.25,), 0), None, None)),
]


@pytest.mark.parametrize("n1,counts,spares,deg0,deg1", DEGRADED)
def test_verdicts_match_reference_on_degradation_ledgers(n1, counts, spares,
                                                         deg0, deg1):
    """Degradation ledgers ride with their physical domain: per stage one
    tuple per domain; the first two stages get ``deg0`` / ``deg1``."""
    pp = len(counts)
    degraded = [None] * pp
    d = len(counts[0])
    degraded[0] = tuple(deg0) + (None,) * (d - len(deg0))
    degraded[1] = tuple(deg1) + (None,) * (d - len(deg1))
    _parity_all_modes(n1, counts, spares, degraded)


@settings(max_examples=30, deadline=None)
@given(REF._layouts(), st.data())
def test_hypothesis_degraded_verdicts_match_reference(layout, data):
    n1, counts, spares = layout
    kinds = st.sampled_from([None, ((1.5,), (), 0), ((), (0.5,), 0),
                             ((), (), 1), ((2.0,), (0.25,), 0)])
    degraded = tuple(tuple(data.draw(kinds) for _ in c) for c in counts)
    _parity_all_modes(n1, counts, spares, degraded)


def test_goodput_model_matches_reference():
    """`effective_tp`, `replica_degradations`'s order and `goodput` (an SDC
    suspect at 0) on the reference's degradation-weighting inputs."""
    counts = [np.array([0, 1]), np.array([0, 0])]
    cases = [None, [[None, None], [((), (), 0), None]],
             [[None, None], [((2.0,), (), 0), None]],
             [[((), (0.5,), 0), None], [None, None]],
             [[((), (), 1), None], [None, None]]]
    for method in ("ntp", "ntp_pw"):
        tg = tcl.GoodputModel(n1=4, method=method)
        jg = jcl.GoodputModel(n1=4, method=method)
        assert tg.effective_tp(counts).tolist() == \
            jg.effective_tp(counts).tolist()
        for case in cases:
            t_degs, j_degs = (None if case is None else [
                [None if x is None else ev.DomainDegradation(*x)
                 for x in stage] for stage in case] for ev in (tev, jev))
            assert tg.goodput(counts, t_degs) == jg.goodput(counts, j_degs)
            assert tg.replica_degradations(counts, t_degs) == (
                None if jg.replica_degradations(counts, j_degs) is None
                else tuple(tev.DomainDegradation(d.straggle, d.link, d.sdc)
                           for d in jg.replica_degradations(counts, j_degs)))
        assert tg.gain_seconds(0.25, 100) == jg.gain_seconds(0.25, 100)


def test_for_perf_and_analytic_match_reference():
    for hw_kw, wl_kw, par_kw in (
            ({}, {}, dict(tp=32, pp=4, dp=8)),
            (dict(domain_size=8), dict(n_params=7e9, n_layers=28,
                                       d_model=3584), dict(tp=8, pp=2, dp=4)),
            (dict(scaleup_bw=4.5e11), dict(n_layers=64), dict(tp=16, pp=8,
                                                              dp=16))):
        thw, jhw = tpm.Hardware(**hw_kw), jpm.Hardware(**hw_kw)
        twl, jwl = tpm.Workload(**wl_kw), jpm.Workload(**wl_kw)
        tpar, jpar = tpm.Parallel(**par_kw), jpm.Parallel(**par_kw)
        tc = tcl.TransitionCostModel.analytic(twl, tpar)
        jc = jcl.TransitionCostModel.analytic(jwl, jpar)
        assert (dict(tc.family_layer_bytes), tc.n_layers, tc.pp,
                tc.scaleup_bw) == (dict(jc.family_layer_bytes), jc.n_layers,
                                   jc.pp, jc.scaleup_bw)
        for method in ("ntp", "ntp_pw"):
            tg = tcl.GoodputModel.for_perf(thw, twl, tpar, method=method)
            jg = jcl.GoodputModel.for_perf(jhw, jwl, jpar, method=method)
            assert (tg.n1, tg.method, tg.step_time_s) == \
                (jg.n1, jg.method, jg.step_time_s)
            assert tg.goodput([np.zeros(par_kw["dp"], int)] * tpar.pp) == 1.0
            counts = [np.arange(par_kw["dp"]) % 3] * tpar.pp
            assert tg.goodput(counts) == jg.goodput(counts)
    assert tcl.TransitionCostModel(family_layer_bytes={4: 1}, n_layers=1,
                                   pp=1).scaleup_bw == \
        jcl.TransitionCostModel(family_layer_bytes={4: 1}, n_layers=1,
                                pp=1).scaleup_bw == 9e11


def test_allocator_units_and_refusals():
    """`make_allocator`, a spare on the worst site, a swap concentrating
    skew, a dead domain rescued, unstaged health refused — as the
    reference's unit tests, on the port."""
    assert tcl.make_allocator("off") is None and tcl.make_allocator(None) is None
    assert isinstance(tcl.make_allocator("greedy", horizon_steps=7),
                      tcl.GreedyAllocator)
    with pytest.raises(ValueError, match="greedy"):
        tcl.make_allocator("annealed")
    gp = tcl.GreedyAllocator().plan(health_of(4, ((1, 0), (3, 0))), spares=1)
    assert gp.spare_sites == ((1, 0, 3),) and gp.counts == ((1, 0), (0, 0))
    gm = tcl.GoodputModel(n1=4)
    gp = tcl.GreedyAllocator(goodput=gm).plan(health_of(4, ((2, 2), (0, 0))),
                                              spares=0)
    assert gp.swaps and gm.effective_tp(
        [np.array(c) for c in gp.counts]).tolist() == [2, 4]
    h = health_of(4, ((4, 0), (1, 0)))
    with pytest.raises(tev.DeadReplicaError):
        tcl.GreedyAllocator().plan(h, spares=0)
    gp = tcl.GreedyAllocator().plan(h, spares=1)
    assert gp.decisions[0].rescue and gp.baseline is None
    with pytest.raises(AssertionError):
        tcl.GreedyAllocator().plan(tev.ClusterHealth(4, (0, 0)))
    with pytest.raises(AssertionError):
        tcl.Action("teleport")
    # staged_plan_from_health delegates to the allocator at pp > 1
    h = health_of(4, ((1, 0), (3, 0)))
    assert tev.staged_plan_from_health(
        h, spares=1, allocator=tcl.GreedyAllocator()) == \
        tcl.GreedyAllocator().plan(h, spares=1).staged_plan


# ---------------------------------------------------------------------------
# the cost model against the reference and the executed ledger

def _cost_cfgs(**kw):
    kw = dict(dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16,
                   d_ff=256, unit_rows=64, n_layers=4, vocab=128), **kw)
    return jnt.NTPModelConfig(**kw), tnt.NTPModelConfig(**kw)


def _plans(stage_tps, n1=2):
    return (tnu.StagedPlan(tuple(tnu.FailurePlan(n1, t) for t in stage_tps)),
            jnu.StagedPlan(tuple(jnu.FailurePlan(n1, t) for t in stage_tps)))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("stage_tps", [((2, 2), (2, 2)), ((1, 2), (2, 1))],
                         ids=str)
def test_from_trees_matches_reference(moe, stage_tps):
    """`from_trees` on the port's packed params + an AdamW-moment-like
    tree equals the reference's on the JAX trees packed from the same
    canonical params; `from_rank_trees` on every process's slots (a 2-D
    mesh process and each stage of a staged mesh) equals it too."""
    kw = dict(n_experts=6, top_k=2, d_ff=128, n_layers=2) if moe else {}
    jcfg, tcfg = _cost_cfgs(**kw)
    tplan, jplan = _plans(stage_tps)
    canon_j = jax.tree.map(np.asarray,
                           jnt.init_canonical(jcfg, jax.random.PRNGKey(3)))
    jparams = jnt.pack_params(jcfg, canon_j, jplan)
    jm = jax.tree.map(np.zeros_like, jparams)
    want = jcl.TransitionCostModel.from_trees(jcfg, [jparams, jm], pp=2)
    canon = ntp_params_from_jax(canon_j, device="cpu")
    tparams = tnt.pack_params(tcfg, canon, tplan)
    tm = tr.tree_map(lambda t: t.new_zeros(t.shape), tparams)
    got = tcl.TransitionCostModel.from_trees(tcfg, [tparams, tm], pp=2)
    assert dict(got.family_layer_bytes) == dict(want.family_layer_bytes)
    assert (got.n_layers, got.pp, got.scaleup_bw) == \
        (want.n_layers, want.pp, want.scaleup_bw)
    if moe:
        assert tcfg.k_ff in got.family_layer_bytes   # the expert family
    for stage in (None, 0, 1):
        for replica, rank in ((0, 0), (1, 1)):
            p = tnt.pack_rank_params(tcfg, canon, tplan, replica, rank, stage)
            m = tr.tree_map(lambda t: t.new_zeros(t.shape), p)
            rc = tcl.TransitionCostModel.from_rank_trees(tcfg, [p, m], pp=2,
                                                         stage=stage)
            assert dict(rc.family_layer_bytes) == dict(want.family_layer_bytes)


@pytest.mark.parametrize("old,new", [
    (((2, 2), (2, 2)), ((2, 2), (1, 2))),
    (((1, 2), (2, 2)), ((2, 2), (1, 1))),
    (((1, 2), (2, 1)), ((2, 2), (2, 2))),
])
def test_cost_model_matches_executed_ledger(old, new):
    """`from_trees` + `predict` == the port's executed
    `transition_staged_trees` ledger (the reference's three pairs), total
    and per stage, with an optimizer-like tree riding along; equal to the
    reference's prediction."""
    jcfg, tcfg = _cost_cfgs()
    (told, jold), (tnew, jnew) = _plans(old), _plans(new)
    canon_j = jax.tree.map(np.asarray,
                           jnt.init_canonical(jcfg, jax.random.PRNGKey(0)))
    params = tnt.pack_params(tcfg, ntp_params_from_jax(canon_j, device="cpu"),
                             told)
    trees = [params, tr.tree_map(lambda t: t.new_zeros(t.shape), params)]
    cost = tcl.TransitionCostModel.from_trees(tcfg, trees, pp=2)
    predicted = cost.predict(told, tnew)
    assert isinstance(predicted, tcl.TransitionCost)
    _, stats = transition_staged_trees(tcfg, trees, told, tnew,
                                       copy_unchanged=False)
    assert predicted.total_bytes == stats.bytes_moved
    for s in range(2):
        booked = sum(n for k, n in stats.per_pair.items() if k[0] == s)
        assert (predicted.stage_bytes[s] == 0) == (booked == 0)
        if old[s] == new[s]:
            assert predicted.stage_bytes[s] == 0
            assert not any(k[0] == s for k in stats.per_pair)
    assert predicted.seconds == predicted.total_bytes / cost.scaleup_bw
    jparams = jnt.pack_params(jcfg, canon_j, jold)
    jcost = jcl.TransitionCostModel.from_trees(
        jcfg, [jparams, jax.tree.map(np.zeros_like, jparams)], pp=2)
    assert predicted.stage_bytes == jcost.predict(jold, jnew).stage_bytes
    assert cost.predict_bytes(told, told) == 0
    assert cost.predict_bytes(None, tnew) == 0


# ---------------------------------------------------------------------------
# packing_stats

@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(0, 8), min_size=16, max_size=64))
def test_packing_stats_match_reference(failed):
    """On the inputs of tests/test_cluster_models.py::test_packing_properties
    (also at other domain sizes): assignments and stats equal."""
    failed = np.array(failed[: len(failed) - len(failed) % 8])
    if len(failed) < 8:
        return
    for dsize, per in ((32, 8), (8, 4), (8, 1)):
        t = trm.pack_replicas(failed, dsize, per)
        j = jrm.pack_replicas(failed, dsize, per)
        assert [(a.domain_ids.tolist(), a.failed.tolist(), a.tp,
                 a.donated_gpus) for a in t] == \
            [(a.domain_ids.tolist(), a.failed.tolist(), a.tp,
              a.donated_gpus) for a in j]
        assert trm.packing_stats(t, dsize) == jrm.packing_stats(j, dsize)
    st_ = trm.packing_stats(trm.pack_replicas(failed, 32, 8), 32)
    assert st_["affected_replicas"] == int(np.ceil((failed > 0).sum() / 8))

