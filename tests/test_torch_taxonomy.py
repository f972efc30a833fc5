"""The port's health-state taxonomy and analytic layer against the JAX
package's, on the CPU (host-side numpy on both sides, so everything here is
compared bit for bit unless a tolerance is named):

* events, `inverse`, `DomainDegradation`, the `ClusterHealth` and
  `StagedHealth` ledgers and `plan_from_health` / `staged_plan_from_health`
  after every event of hypothesis-drawn interleavings of all eight kinds
  (mirrors `tests/test_taxonomy_properties.py`);
* `simulate_events` arrays for binary and mixed trace configs over several
  seeds, `simulate_trace`, `fraction_time_above`, and `parse_trace_mix`'s
  errors;
* `table1_settings`, `throughput_loss_curve` and
  `steady_state_failed_fraction` against `tests/golden/analytic_golden.json`
  within its REL_TOL 1e-6, and the rest of `core/policies.py` and
  `core/availability.py` against the reference.
"""
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import availability as jav
from repro.core import failure_model as jfm
from repro.core import policies as jpol
from repro.runtime import events as jev
from repro_torch.core import availability as tav
from repro_torch.core import failure_model as tfm
from repro_torch.core import policies as tpol
from repro_torch.runtime import events as tev

KINDS = ("FailureEvent", "RecoveryEvent", "StragglerEvent",
         "StragglerClearEvent", "LinkDegradeEvent", "LinkRepairEvent",
         "SdcSuspectEvent", "SdcClearEvent")
SLOW = (1.25, 1.7, 2.5, 3.0)
BW = (0.2, 0.45, 0.9)


def _pair(kind, **kw):
    """The same event in both packages."""
    return getattr(jev, kind)(**kw), getattr(tev, kind)(**kw)


def _deg(d):
    return None if d is None else (d.straggle, d.link, d.sdc)


def _health(h):
    """A ClusterHealth as plain values (either package)."""
    return (h.domain_size, h.failed, h.domains_per_replica,
            None if h.degraded is None else tuple(_deg(d) for d in h.degraded))


def _plan(fn, *a, **kw):
    try:
        p = fn(*a, **kw)
    except Exception as e:  # both must refuse the same way
        return ("raised", type(e).__name__, str(e))
    if hasattr(p, "stages"):
        return tuple((s.n1, s.replica_tp) for s in p.stages)
    return (p.n1, p.replica_tp)


def _views(h, staged: bool):
    """Everything a ledger exposes, as plain values."""
    out = {"degs": tuple((d.straggle, d.link, d.sdc, d.slow_factor, d.bw_frac,
                          d.clear) for d in h.replica_degradations()),
           "healthy": h.healthy, "n_replicas": h.n_replicas}
    if staged:
        out["stages"] = tuple(_health(s) for s in h.stages)
        out["states"] = tuple(tuple(x.value for x in s.domain_states())
                              for s in h.stages)
    else:
        out["health"] = _health(h)
        out["states"] = tuple(x.value for x in h.domain_states())
        out["assign"] = tuple((a.tp, tuple(a.domain_ids), tuple(a.failed))
                              for a in h.assignments())
    return out


def _fold(events, staged: bool, n_domains: int, dpr: int = 1, pp: int = 2,
          spares: int = 0):
    """Apply the event pairs to both packages' ledgers, comparing every view
    and the plans after every event (a refusal must match too)."""
    if staged:
        jh = jev.StagedHealth.pristine(n_domains, 4, pp)
        th = tev.StagedHealth.pristine(n_domains, 4, pp)
        plan_j, plan_t = jev.staged_plan_from_health, tev.staged_plan_from_health
    else:
        jh = jev.ClusterHealth.pristine(n_domains, 4, dpr)
        th = tev.ClusterHealth.pristine(n_domains, 4, dpr)
        plan_j, plan_t = jev.plan_from_health, tev.plan_from_health
    for je, te in events:
        try:
            jn = jh.apply(je)
        except (ValueError, AssertionError) as e:
            with pytest.raises(ValueError) as ti:
                th.apply(te)
            assert str(ti.value) == str(e) or isinstance(e, AssertionError)
            continue
        jh, th = jn, th.apply(te)
        assert _views(jh, staged) == _views(th, staged), (je, te)
        assert _plan(plan_j, jh, spares=spares) == \
            _plan(plan_t, th, spares=spares)
    return jh, th


def _event_pairs(draw_kind, site, severity, n_gpus):
    kind = KINDS[draw_kind]
    kw = dict(site, n_gpus=n_gpus)
    if kind.startswith("Straggler"):
        kw["slowdown"] = SLOW[severity % len(SLOW)]
    elif kind.startswith("Link"):
        kw["bw_frac"] = BW[severity % len(BW)]
    return _pair(kind, **kw)


SITES = st.one_of(
    st.builds(lambda d: {"domain": d}, st.integers(0, 3)),
    st.builds(lambda r: {"replica": r}, st.integers(0, 2)),
)
EVENTS = st.lists(
    st.builds(_event_pairs, st.integers(0, 7), SITES, st.integers(0, 11),
              st.integers(1, 2)),
    max_size=24)
STAGED_SITES = st.one_of(
    st.builds(lambda d: {"domain": d}, st.integers(0, 5)),
    st.builds(lambda r: {"replica": r}, st.integers(0, 2)),
    st.builds(lambda s, d: {"stage": s, "domain": d}, st.integers(0, 2),
              st.integers(0, 2)),
)
STAGED_EVENTS = st.lists(
    st.builds(_event_pairs, st.integers(0, 7), STAGED_SITES,
              st.integers(0, 11), st.integers(1, 2)),
    max_size=20)


@settings(max_examples=60, deadline=None)
@given(EVENTS, st.sampled_from([(2, 1, 0), (4, 2, 0), (3, 1, 1)]))
def test_cluster_health_ledger_matches_reference(events, geometry):
    """(domains, domains per replica, spares): every view of the ledger and
    the packed plan after every event, equal to the reference's."""
    n_domains, dpr, spares = geometry
    _fold(events, staged=False, n_domains=n_domains, dpr=dpr, spares=spares)


@settings(max_examples=40, deadline=None)
@given(STAGED_EVENTS)
def test_staged_health_ledger_matches_reference(events):
    """pp=2 over 2 domains a stage: per-stage ledgers, the merged
    per-replica degradations and `staged_plan_from_health`."""
    jh, th = _fold(events, staged=True, n_domains=2)
    for spares in (0, 1):   # spares at pp>1 are refused alike
        assert _plan(jev.staged_plan_from_health, jh, spares=spares)[:2] == \
            _plan(tev.staged_plan_from_health, th, spares=spares)[:2]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.builds(_event_pairs, st.integers(0, 7),
                          st.builds(lambda d: {"domain": d},
                                    st.integers(0, 1)),
                          st.integers(0, 11), st.just(1)), max_size=12),
       st.builds(_event_pairs, st.integers(0, 7),
                 st.builds(lambda d: {"domain": d}, st.integers(0, 1)),
                 st.integers(0, 11), st.just(1)))
def test_inverse_round_trip_matches_reference(base, ev):
    """`inverse` in both packages; apply(e) then apply(inverse(e)) lands on
    the same ledger in both (the identity wherever neither saturates)."""
    je, te = ev
    ji, ti = jev.inverse(je), tev.inverse(te)
    assert type(ji).__name__ == type(ti).__name__
    assert vars(ji) == vars(ti)
    assert tev.inverse(ti) == te
    jh, th = _fold(base, staged=False, n_domains=2)
    try:
        jr = jh.apply(je).apply(jev.inverse(je))
    except (ValueError, AssertionError):
        return
    tr_ = th.apply(te).apply(tev.inverse(te))
    assert _health(jr) == _health(tr_)


@pytest.mark.parametrize("kind", KINDS)
def test_event_fields_and_kinds_match_reference(kind):
    kw = {"domain": 1, "step": 3, "n_gpus": 2}
    if kind.startswith("Straggler"):
        kw["slowdown"] = 1.5
    elif kind.startswith("Link"):
        kw["bw_frac"] = 0.5
    je, te = _pair(kind, **kw)
    assert jev.event_kind(je) == tev.event_kind(te)
    assert type(jev.inverse(je)).__name__ == type(tev.inverse(te)).__name__
    assert isinstance(te, tev.DEGRADATION_EVENTS) == \
        isinstance(je, jev.DEGRADATION_EVENTS)
    assert tev.EVENT_KIND_NAMES == jev.EVENT_KIND_NAMES
    assert [s.value for s in tev.HealthState] == \
        [s.value for s in jev.HealthState]
    with pytest.raises(ValueError) as te_err:
        getattr(tev, kind)(domain=0, replica=0)
    with pytest.raises(ValueError) as je_err:
        getattr(jev, kind)(domain=0, replica=0)
    assert str(te_err.value) == str(je_err.value)


@pytest.mark.parametrize("bad", [
    ("StragglerEvent", {"slowdown": 1.0}),
    ("StragglerClearEvent", {"slowdown": 0.5}),
    ("LinkDegradeEvent", {"bw_frac": 1.0}),
    ("LinkRepairEvent", {"bw_frac": 0.0}),
])
def test_event_severity_refusals_match_reference(bad):
    kind, kw = bad
    with pytest.raises(ValueError) as te_err:
        getattr(tev, kind)(domain=0, **kw)
    with pytest.raises(ValueError) as je_err:
        getattr(jev, kind)(domain=0, **kw)
    assert str(te_err.value) == str(je_err.value)


def test_domain_degradation_merge_and_factors_match_reference():
    a = dict(straggle=(1.5, 2.0), link=(0.3,), sdc=1)
    b = dict(straggle=(1.2,), link=(0.25, 0.8), sdc=0)
    jm = jev.DomainDegradation(**a).merge(jev.DomainDegradation(**b))
    tm = tev.DomainDegradation(**a).merge(tev.DomainDegradation(**b))
    assert (jm.straggle, jm.link, jm.sdc, jm.slow_factor, jm.bw_frac) == \
        (tm.straggle, tm.link, tm.sdc, tm.slow_factor, tm.bw_frac)
    assert tev.CLEAR_DEGRADATION.clear and tev.CLEAR_DEGRADATION.slow_factor == 1.0
    with pytest.raises(ValueError):
        tev.DomainDegradation(straggle=(2.0, 1.5))
    with pytest.raises(TypeError, match="not a degradation event"):
        tev.CLEAR_DEGRADATION.apply(tev.FailureEvent(domain=0))


def test_staged_allocator_is_not_ported():
    """The name predates the allocator's port: `staged_plan_from_health`
    now delegates to an allocator at pp > 1 (its verdict's staged plan), and
    without one packs stage by stage."""
    from repro_torch.cluster import GreedyAllocator

    h = tev.StagedHealth.pristine(2, 4, 2)
    hurt = h.apply(tev.FailureEvent(stage=1, domain=0))
    assert tev.staged_plan_from_health(
        hurt, spares=1, allocator=GreedyAllocator()).healthy
    with pytest.raises(ValueError, match="global allocator"):
        tev.staged_plan_from_health(hurt, spares=1)
    plan = tev.staged_plan_from_health(h)
    assert isinstance(plan, tev.StagedPlan) and plan.pp == 2
    assert [s.replica_tp for s in plan.stages] == [(4, 4), (4, 4)]


# --------------------------------------------------------------- traces

def _trace_configs():
    mixed = dict(straggler_rate_mult=2.0, link_rate_mult=1.5,
                 sdc_rate_mult=0.5)
    return [
        ("binary", dict(n_gpus=512, domain_size=8, days=3.0,
                        rate_multiplier=20.0)),
        ("mixed", dict(n_gpus=512, domain_size=8, days=3.0,
                       rate_multiplier=20.0, **mixed)),
        ("chip", dict(n_gpus=8, domain_size=4, days=16 / 24.0,
                      rate_multiplier=200.0, straggler_rate_mult=2.0,
                      link_rate_mult=2.0, sdc_rate_mult=1.0)),
    ]


@pytest.mark.parametrize("seed", [0, 1, 7, 136])
@pytest.mark.parametrize("name,kw", _trace_configs(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_simulate_events_bit_identical(name, kw, seed):
    je = jfm.simulate_events(jfm.FailureTraceConfig(seed=seed, **kw))
    te = tfm.simulate_events(tfm.FailureTraceConfig(seed=seed, **kw))
    for f in ("start_h", "end_h", "gpu", "domain", "is_hw", "kind",
              "severity"):
        a, b = getattr(je, f), getattr(te, f)
        if a is None:
            assert b is None, f
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    t = np.arange(0.0, 40.0, 0.5)
    n_dom = kw["n_gpus"] // kw["domain_size"]
    assert np.array_equal(je.failed_counts_scan(t, n_dom, kw["domain_size"]),
                          te.failed_counts_scan(t, n_dom, kw["domain_size"]))
    for k in range(4):
        assert np.array_equal(je.live_total_scan(t, k),
                              te.live_total_scan(t, k))


@pytest.mark.parametrize("seed", [0, 3])
def test_fig4_views_match_reference(seed):
    kw = dict(n_gpus=4096, domain_size=32, days=4.0, rate_multiplier=3.0,
              seed=seed)
    jc, tc = jfm.FailureTraceConfig(**kw), tfm.FailureTraceConfig(**kw)
    (jt, jn), (tt, tn) = jfm.simulate_trace(jc), tfm.simulate_trace(tc)
    assert np.array_equal(jt, tt) and np.array_equal(jn, tn)
    assert jfm.fraction_time_above(jc, 1e-4) == \
        tfm.fraction_time_above(tc, 1e-4)
    assert jfm.steady_state_failed_fraction(jc) == \
        tfm.steady_state_failed_fraction(tc)


@pytest.mark.parametrize("spec", [
    "", "  ,  ", "straggler", "gpu=1", "sdc=x", "link=-1", "sdc=1,sdc=2",
    "straggler=0.5,link=2,sdc=0.1", "link=3",
])
def test_parse_trace_mix_matches_reference(spec):
    try:
        want = jfm.parse_trace_mix(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfm.parse_trace_mix(spec)
        assert str(got.value) == str(e)
        return
    assert tfm.parse_trace_mix(spec) == want


# ------------------------------------------------------- analytic layer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "analytic_golden.json")
REL_TOL = 1e-6   # tests/test_golden_analytic.py


def _flatten(prefix, obj, out):
    if isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(f"{prefix}.{k}", obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}[{i}]", v, out)
    else:
        out[prefix] = obj


@pytest.mark.parametrize("key", ["table1_settings", "throughput_loss_curve",
                                 "steady_state_failed_fraction"])
def test_analytic_layer_matches_golden(key):
    """The port's analytic values against the golden file, key by key. Its
    fourth key, ``serving_goodput``, is computed by
    `serve/router.py::serving_goodput_trace`, which the port does not have
    yet (ROADMAP Queue 1 item 7), so it is not compared here."""
    with open(GOLDEN) as f:
        golden = json.load(f)[key]
    spec = tav.ClusterSpec(n_gpus=4096, domain_size=32, domains_per_replica=4)
    actual = {
        "table1_settings": lambda: tpol.table1_settings(),
        "throughput_loss_curve": lambda: {
            "spec": {"n_gpus": spec.n_gpus, "domain_size": spec.domain_size,
                     "domains_per_replica": spec.domains_per_replica},
            "failed_fractions": [1e-3, 2e-3, 4e-3], "samples": 4, "seed": 0,
            "curves": tpol.throughput_loss_curve(spec, [1e-3, 2e-3, 4e-3],
                                                 samples=4, seed=0)},
        "steady_state_failed_fraction": lambda: {
            "rate_1x": tfm.steady_state_failed_fraction(
                tfm.FailureTraceConfig()),
            "rate_3x": tfm.steady_state_failed_fraction(
                tfm.FailureTraceConfig(rate_multiplier=3.0))},
    }[key]()
    want, got = {}, {}
    _flatten(key, golden, want)
    _flatten(key, actual, got)
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], float) or isinstance(got[k], float):
            assert got[k] == pytest.approx(want[k], rel=REL_TOL, abs=1e-12), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("method", ["dpdrop", "ntp", "ntp_pw"])
def test_cluster_throughput_and_spares_match_reference(method):
    rng = np.random.default_rng(5)
    jspec = jav.ClusterSpec(n_gpus=2048, domain_size=32, domains_per_replica=4)
    tspec = tav.ClusterSpec(n_gpus=2048, domain_size=32, domains_per_replica=4)
    trace = [jav.sample_failed_domains(2048, 32, int(n), rng)
             for n in (0, 3, 9, 20)]
    for counts in trace:
        for spares in (0, 2):
            a = jpol.cluster_throughput(jspec, counts, method,
                                        n_spare_domains=spares)
            b = tpol.cluster_throughput(tspec, counts, method,
                                        n_spare_domains=spares)
            assert a == b
    assert jpol.spares_analysis(jspec, trace, range(0, 9, 4), method) == \
        tpol.spares_analysis(tspec, trace, range(0, 9, 4), method)


@pytest.mark.parametrize("tp", [32, 30, 28, 16, 1, 0])
def test_replica_throughput_and_staged_rel_match_reference(tp):
    for method in ("ntp", "ntp_pw"):
        for sf, bw in ((1.0, 1.0), (1.6, 1.0), (1.0, 0.4), (2.2, 0.7)):
            a = jpol.replica_throughput(tp, 32, jpol.WorkloadGeometry(),
                                        method, jpol.PowerModel(),
                                        slow_factor=sf, bw_frac=bw)
            b = tpol.replica_throughput(tp, 32, tpol.WorkloadGeometry(),
                                        method, tpol.PowerModel(),
                                        slow_factor=sf, bw_frac=bw)
            assert a == b
    if tp:
        kw = dict(local_batches=(8, 5), local_batch=8, boosts=(1.0, 1.3),
                  slow_factors=(1.0, 1.4), bw_fracs=(0.5, 1.0))
        assert jpol.staged_rel_iter_times(
            ((32, tp), (tp, 32)), 32, jpol.WorkloadGeometry(), **kw) == \
            tpol.staged_rel_iter_times(
                ((32, tp), (tp, 32)), 32, tpol.WorkloadGeometry(), **kw)


@pytest.mark.parametrize("blast", [1, 4])
def test_availability_matches_reference(blast):
    jspec = jav.ClusterSpec(n_gpus=4096, domain_size=64)
    tspec = tav.ClusterSpec(n_gpus=4096, domain_size=64)
    for f in (1e-3, 1e-2):
        assert jav.availability_full_tp(jspec, f, samples=20,
                                        blast_radius=blast, seed=2) == \
            tav.availability_full_tp(tspec, f, samples=20,
                                     blast_radius=blast, seed=2)
        assert jav.availability_analytic(64, f) == \
            tav.availability_analytic(64, f)
