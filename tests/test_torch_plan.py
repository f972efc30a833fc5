"""Host-side planning and policy of the port against the JAX package, bit for
bit: Algorithm-1 reshard tables and transition plans over a sweep of
(k, n1, tp), the serving unit specs, the power/slowdown models and the
failure/repair ledger."""
import itertools

import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import policies as jpol
from repro.core import shard_mapping as jsm
from repro.core.power import PowerModel as JPowerModel
from repro.reshard import planner as jplanner
from repro.reshard.state import degree_layout as jdegree_layout
from repro.reshard.units import serve_unit_count as jserve_unit_count
from repro.runtime import events as jev
from repro.serve import router as jrouter
from repro_torch.configs import get_arch, reduced
from repro_torch.core import policies as tpol
from repro_torch.core import shard_mapping as tsm
from repro_torch.core.power import PowerModel
from repro_torch.reshard import planner as tplanner
from repro_torch.reshard.state import degree_layout
from repro_torch.reshard.units import cache_unit_resolver, serve_unit_count
from repro_torch.runtime import events as tev
from repro_torch.serve import router as trouter

SWEEP = [(k, n1, tp) for k in (1, 2, 3, 4, 7, 8, 28) for n1 in (1, 2, 3, 4, 8)
         for tp in range(1, n1 + 1)]


def _same_tables(a, b):
    assert (a.n, a.s_max, a.buf, a.pad) == (b.n, b.s_max, b.buf, b.pad)
    for f in ("send_idx", "recv_idx", "stay_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.moved_units_per_rank(), b.moved_units_per_rank())


@pytest.mark.parametrize("k,n1,tp", [c for c in SWEEP if c[0] >= c[1]])
def test_reshard_tables_bit_identical(k, n1, tp):
    for tl, jl in ((tsm.comp_layout(k, n1, tp), jsm.comp_layout(k, n1, tp)),
                   (tsm.sync_layout(k, n1, tp), jsm.sync_layout(k, n1, tp))):
        assert np.array_equal(tl.assignment, jl.assignment)
        assert np.array_equal(tl.slots, jl.slots)
    tc, ts, tpre, tpost = tsm.plan(k, n1, tp)
    jc, js, jpre, jpost = jsm.plan(k, n1, tp)
    _same_tables(tpre, jpre)
    _same_tables(tpost, jpost)
    assert np.array_equal(tsm.transfer_matrix(tc, ts), jsm.transfer_matrix(jc, js))
    assert np.array_equal(tsm.reshard_bytes_per_rank(tc, ts, 512),
                          jsm.reshard_bytes_per_rank(jc, js, 512))


def test_transition_plans_bit_identical():
    for k, n1, tp in SWEEP:
        for tp2 in range(1, n1 + 1):
            src = (tplanner.sync_key(k, n1, tp), jplanner.sync_key(k, n1, tp))
            dst = (tplanner.sync_key(k, n1, tp2), jplanner.sync_key(k, n1, tp2))
            t = tplanner.transition_plan(src[0], dst[0], k, k)
            j = jplanner.transition_plan(src[1], dst[1], k, k)
            _same_tables(t.tables, j.tables)
            for f in ("stay_rank", "stay_src_slot", "stay_dst_slot",
                      "move_src_rank", "move_src_slot", "move_dst_rank",
                      "move_dst_slot", "transfer"):
                assert np.array_equal(getattr(t, f), getattr(j, f)), f
            assert (t.n_moved, t.n_stay, t.pairs, t.identity) == (
                j.n_moved, j.n_stay, j.pairs, j.identity)
            tl, jl = degree_layout(k, tp, n1), jdegree_layout(k, tp, n1)
            assert np.array_equal(tl.slots, jl.slots)
        if k >= n1:
            ck = (tplanner.comp_key(k, n1, n1, tp), jplanner.comp_key(k, n1, n1, tp))
            assert np.array_equal(tplanner.layout(ck[0]).assignment,
                                  jplanner.layout(ck[1]).assignment)


def test_serve_units_match_reference():
    for j, t in ((jget_arch("qwen2-7b"), get_arch("qwen2-7b")),
                 (jreduced(jget_arch("qwen2-7b")), reduced(get_arch("qwen2-7b")))):
        assert serve_unit_count(t) == jserve_unit_count(j)
        spec = cache_unit_resolver(t)("k")
        assert (spec.kind, spec.k, spec.axis) == ("kv_head", t.n_kv_heads, -2)
    with pytest.raises(ValueError, match="unknown state leaf 'h'"):
        cache_unit_resolver(get_arch("qwen2-7b"))("h")


def test_power_and_slowdown_models_match_reference():
    tp_, jp_ = PowerModel(), JPowerModel()
    for m in (0.5, 1.0, 1.15, 1.3, 2.0):
        assert tp_.speedup(m) == jp_.speedup(m)
    for n1 in (4, 8, 32):
        for tp in range(1, n1 + 1):
            assert tp_.required_power(tp, n1) == jp_.required_power(tp, n1)
            assert tp_.can_boost(tp, n1) == jp_.can_boost(tp, n1)
    for heads in (4, 28, 128):
        tg = tpol.WorkloadGeometry(n_heads=heads, mlp_flops_share=1 / 3)
        jg = jpol.WorkloadGeometry(n_heads=heads, mlp_flops_share=1 / 3)
        for tp, sf, bw in itertools.product((1, 2, 3, 4), (1.0, 1.5), (1.0, 0.5)):
            t = tpol.stage_slowdown(tp, 4, tg, slow_factor=sf, bw_frac=bw)
            assert t == jpol.stage_slowdown(tp, 4, jg, slow_factor=sf, bw_frac=bw)
            assert tpol.boosted_operating_point(t, tp_) == \
                jpol.boosted_operating_point(t, jp_)
            assert tpol.degradation_slowdown(sf, bw, tg) == \
                jpol.degradation_slowdown(sf, bw, jg)
            for method in ("drop", "ntp", "ntp_pw"):
                assert trouter.replica_serve_speed(
                    tp, 4, method, geom=tg, slow_factor=sf, bw_frac=bw
                ) == jrouter.replica_serve_speed(
                    tp, 4, method, geom=jg, slow_factor=sf, bw_frac=bw)
    assert tpol.stage_slowdown(0, 4, tpol.WorkloadGeometry()) == np.inf


def test_health_ledger_matches_reference():
    rng = np.random.default_rng(0)
    th = tev.ClusterHealth.pristine(3, 4)
    jh = jev.ClusterHealth.pristine(3, 4)
    for _ in range(60):
        dom, n = int(rng.integers(0, 3)), int(rng.integers(1, 3))
        fail = bool(rng.integers(0, 2))
        tcls = tev.FailureEvent if fail else tev.RecoveryEvent
        jcls = jev.FailureEvent if fail else jev.RecoveryEvent
        th = th.apply(tev.resolve_serving_domain(tcls(replica=dom, n_gpus=n), 3))
        jh = jh.apply(jev.resolve_serving_domain(jcls(replica=dom, n_gpus=n), 3))
        assert th.failed == jh.failed and th.healthy == jh.healthy
    with pytest.raises(ValueError, match="addresses domain 5"):
        tev.resolve_serving_domain(tev.FailureEvent(domain=5), 3)
    with pytest.raises(ValueError, match="single-stage"):
        tev.resolve_serving_domain(tev.FailureEvent(domain=0, stage=1), 3)
    with pytest.raises(ValueError, match="exactly one of"):
        tev.FailureEvent()
    # a replica-addressed event lands on the replica's worst domain under
    # the current packing, as the reference's training ledger resolves it
    for replica in range(3):
        ev = dict(replica=replica, n_gpus=1)
        assert th.apply(tev.FailureEvent(**ev)).failed == \
            jh.apply(jev.FailureEvent(**ev)).failed
    assert tev.event_kind(tev.RecoveryEvent(domain=0)) == "repair"
