"""The serving lifecycle of the port on the CPU, held against the JAX
package's `ServeSession` and `Router` (the oracles are tests/test_serve.py's
tests of the same names):

* degradations drain-then-retarget: stragglers and degraded links reprice a
  replica in place, nothing is preempted, an SDC suspicion drains it until
  the clear; each transition record equal to the reference's field for
  field (kind, TPs, preempted, rel_speed, power_boost, draining);
* clamped failures leave repair debt;
* `save`/`restore` with bf16 caches, under another TP, preempting and
  returning what does not fit (with and without the weights);
* SLO admission and the reject reasons, with the `serve.admission`
  counter;
* `chip_smoke.py`'s mixed chain (`DENSE_CHAIN`: failure, straggler, SDC
  suspicion, save, link, the clears, the repair) on reduced qwen2-7b and
  mamba2-780m: streams, transition records and telemetry events (kind,
  name, labels and value or span attrs; the port's own `kernels.dispatch`
  counters aside) equal to the reference's, streams equal to an
  uninterrupted run, and the restore of the tick-10 checkpoint under TP
  (4, 3) resuming to the same streams;
* the analytic serving goodput (`serving_goodput_trace`,
  `blast_radius_goodput`) equal to the reference's and to its acceptance
  targets;
* the launcher's trace, quarantine and telemetry flags, and their
  argparse errors.

Weights are drawn by the reference's PRNG and carried across with
`convert.params_from_jax`; prompts come from seeded numpy."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro import telemetry as jtelemetry
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.base import ArchConfig as JArchConfig
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeSession as JServeSession
from repro_torch import runtime as truntime
from repro_torch import telemetry
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.runtime import (
    FailureEvent, LinkDegradeEvent, LinkRepairEvent, RecoveryEvent,
    SdcClearEvent, SdcSuspectEvent, StragglerClearEvent, StragglerEvent,
)
from repro_torch.serve import Request, Router, ServeSession

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

N1 = 4
# tests/test_serve.py's CFG_FULL, in both packages
CFG_KW = dict(arch_id="serve-test-attn-kv4", family="dense", citation="test",
              n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
              d_ff=128, vocab_size=128, layer_pattern=("attn",), window=64,
              chunk_size=64)
JCFG, CFG = JArchConfig(**CFG_KW), ArchConfig(**CFG_KW)
SMALL_KW = dict(n1=N1, slots=2, max_len=64, prefill_len=16, policy="ntp")
# the mixed chain's sessions and traffic at CPU size: two replicas of 4
# slots (TP 3 holds 3, so the failure preempts), 16 requests of 4-14
# tokens, two a tick over ticks 0-7, 6 new tokens each
CHAIN_KW = dict(replicas=2, n1=N1, slots=4, max_len=48, prefill_len=16,
                policy="ntp_pw")
CHAIN_REQ, CHAIN_NEW, CHAIN_PER_TICK = 16, 6, 2
RECORD_KEYS = ("replica", "kind", "tp_from", "tp_to", "preempted",
               "rel_speed", "power_boost", "draining", "reshard")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _requests(cls, n, rng, *, max_new=8, lo=4, hi=14, stagger=2):
    """tests/test_serve.py's `_requests`, for either package."""
    out = []
    for i in range(n):
        r = cls(rid=i, prompt=rng.integers(1, 128, size=int(
            rng.integers(lo, hi))).astype(np.int32), max_new=max_new)
        r.arrival = float(stagger * i)
        out.append(r)
    return out


def _records(transitions):
    """Transition records, comparable across the packages: the event by
    class name and fields, then `RECORD_KEYS` (absent keys as None)."""
    return [(type(t["event"]).__name__, dataclasses.asdict(t["event"]),
             *(t.get(k) for k in RECORD_KEYS)) for t in transitions]


def _telemetry(events):
    """Telemetry events by kind, name, labels and value (spans: attrs),
    the port's `kernels.dispatch` counters aside (the reference runs no
    kernel on this path)."""
    return [(e["kind"], e["name"], sorted(e["labels"].items()),
             sorted(e["attrs"].items()) if e["kind"] == "span"
             else e["value"])
            for e in events if not e["name"].startswith("kernels.")]


def _both(fn):
    """Run ``fn(port)`` for the JAX package and the port, each under a
    recorder of its own package. Returns (jax result, jax events, port
    result, port events)."""
    jsink = jtelemetry.MemorySink(maxlen=None)
    with jtelemetry.recording(jtelemetry.Recorder(sinks=[jsink])):
        jout = fn(False)
    tsink = telemetry.MemorySink(maxlen=None)
    with telemetry.recording(telemetry.Recorder(sinks=[tsink])):
        tout = fn(True)
    return jout, _telemetry(jsink.events()), tout, _telemetry(tsink.events())


# ------------------------------------------------------- degradations

def _degradation_chain(session, ev):
    """tests/test_serve.py::test_degradation_drain_then_retarget's chain on
    either package (``ev``: its runtime module); returns what it saw."""
    e0, e1 = session.engines
    seen = []
    pre = session.apply(ev.StragglerEvent(replica=0, slowdown=2.0))
    seen.append((pre, e0.tp, e0.dead, e0.rel_speed, e1.rel_speed,
                 session.transitions[-1]["kind"]))
    pre = session.apply(ev.LinkDegradeEvent(replica=0, bw_frac=0.5))
    seen.append((pre, e0.rel_speed))
    session.apply(ev.StragglerClearEvent(replica=0, slowdown=2.0))
    session.apply(ev.LinkRepairEvent(replica=0, bw_frac=0.5))
    seen.append(e0.rel_speed)
    session.apply(ev.SdcSuspectEvent(replica=0))
    seen.append((e0.draining, e0.can_admit(), e1.can_admit(), e0.dead,
                 e0.rel_speed))
    session.apply(ev.SdcClearEvent(replica=0))
    seen.append((e0.draining, e0.can_admit(), session.health.healthy))
    return seen


def test_degradation_drain_then_retarget():
    """Straggler and link events reprice a replica in place — same TP,
    same cache, nothing preempted — and an SDC suspicion drains it until
    the clear; a degraded-but-complete replica is slowed, never dropped,
    even under ``drop``. Every transition record and telemetry event
    equals the reference's."""
    def run(port):
        cls, ev = ((ServeSession, truntime) if port
                   else (JServeSession, jruntime))
        kw = dict(device="cpu") if port else dict(key=jax.random.PRNGKey(0))
        session = cls.create(CFG if port else JCFG, replicas=2, **SMALL_KW,
                             **kw)
        return session, _degradation_chain(session, ev)

    (js, jseen), jev, (s, seen), tev = _both(run)
    (pre, tp, dead, s0, s1, kind), (pre2, s0b), s0c, drain, clear = seen
    assert pre == [] and tp == N1 and not dead
    assert 0.0 < s0 < 1.0 and s1 == 1.0 and kind == "retarget"
    assert pre2 == [] and s0b < s0          # compounding degradation
    assert s0c == 1.0                       # exact per-kind inverses
    assert drain == (True, False, True, False, drain[4]) and drain[4] > 0
    assert clear == (False, True, True)
    assert seen == jseen
    assert _records(s.transitions) == _records(js.transitions)
    assert tev == jev and [e[1] for e in tev].count("serve.transition") == 6
    assert [type(e).__name__ for e in s.events] == [
        type(e).__name__ for e in js.events]

    drop = ServeSession.create(CFG, replicas=1, **dict(SMALL_KW,
                                                      policy="drop"),
                               device="cpu")
    drop.apply(StragglerEvent(replica=0, slowdown=2.0))
    assert not drop.engines[0].dead
    assert 0.0 < drop.engines[0].rel_speed < 1.0
    off = ServeSession.create(CFG, replicas=1, **SMALL_KW, device="cpu",
                              quarantine=False)
    assert not off.quarantine
    off.apply(SdcSuspectEvent(replica=0))
    assert not off.engines[0].draining and off.engines[0].can_admit()


def test_clamped_failures_leave_repair_debt():
    """5 failures into a 4-wide domain clamp the ledger at 4 (replica dead)
    and leave 1 GPU of repair debt: the first repair is absorbed, the
    second revives the replica at TP 1; `plan` is None while it is dead."""
    def run(port):
        cls, ev = ((ServeSession, truntime) if port
                   else (JServeSession, jruntime))
        kw = dict(device="cpu") if port else dict(key=jax.random.PRNGKey(0))
        session = cls.create(CFG if port else JCFG, replicas=1, **SMALL_KW,
                             **kw)
        for _ in range(5):
            session.apply(ev.FailureEvent(domain=0))
        seen = [(session.replica_tp, session.engines[0].dead, session.plan)]
        session.apply(ev.RecoveryEvent(domain=0))
        seen.append((session.replica_tp, session.engines[0].dead,
                     session.transitions[-1]["kind"]))
        session.apply(ev.RecoveryEvent(domain=0))
        seen.append((session.replica_tp, session.engines[0].dead,
                     session.plan.replica_tp))
        return session, seen

    (js, jseen), jev, (s, seen), tev = _both(run)
    assert seen == [((0,), True, None), ((0,), True, "absorbed"),
                    ((1,), False, (1,))]
    assert seen == jseen
    revival = s.transitions[-1]["reshard"]
    assert revival["bytes_moved"] == 0 and revival["tp_from"] == 0
    assert _records(s.transitions) == _records(js.transitions)
    assert tev == jev


# ------------------------------------------------------------ save/restore

@pytest.mark.parametrize("weights", [True, False])
def test_session_save_restore_bf16_kv_and_resumes_decoding(tmp_path, weights):
    """tests/test_serve.py's test of the same name on the port: a bf16
    checkpoint restored under TP 3 preempts the target's own request and
    the slot beyond its capacity and returns both; the restored slots
    finish with the original session's streams. ``weights=False`` saves no
    weights, and the target session shares the original's."""
    rng = np.random.default_rng(5)
    kw = dict(replicas=1, n1=N1, slots=3, max_len=64, prefill_len=16,
              policy="ntp", dtype=torch.bfloat16, device="cpu")
    session = ServeSession.create(CFG, seed=0, **kw)
    router = Router(session)
    for r in _requests(Request, 3, rng, stagger=0, max_new=16):
        router.submit(r)
    for _ in range(4):
        router.step()
    path = str(tmp_path / "serve.npz")
    session.save(path, weights=weights)
    with np.load(path) as data:
        assert any(k.startswith("params/") for k in data.files) == weights

    other = ServeSession.create(CFG, **kw, **(
        dict(seed=9) if weights else dict(params=session.params)))
    other.apply(FailureEvent(domain=0))         # restore under another TP
    ro_pre = Router(other)
    ro_pre.submit(Request(rid=77, prompt=np.ones(4, np.int32), max_new=30))
    ro_pre.step()
    assert other.engines[0].n_active == 1
    preempted = other.restore(path)
    assert len(preempted) == 2 and other.engines[0].n_active == 2
    assert 77 in {r.rid for r in preempted}
    assert all(t.dtype == torch.bfloat16
               for t in other.engines[0].cache.values())
    for a, b in zip(chip_smoke._leaves(other.params),
                    chip_smoke._leaves(session.params)):
        assert torch.equal(a, b)

    ro = Router(other)
    ro.requeue(preempted)
    ro.drain()
    router.drain()
    got_t = {r.rid: list(r.generated) for r in ro.completed}
    want_t = {r.rid: list(r.generated) for r in router.completed}
    assert len(got_t) == 4 and len(want_t) == 3
    clean = {r.rid for r in ro.completed if r.preemptions == 0} - {77}
    assert len(clean) == 2
    for rid in clean:
        assert got_t[rid] == want_t[rid], rid
    assert all(len(got_t[r]) == 16 for r in got_t if r != 77)
    assert len(got_t[77]) == 30


def test_weightless_checkpoint_refuses_other_weights(tmp_path):
    """A ``weights=False`` checkpoint restores only into a session whose
    weights match the fingerprint it holds: another seed, or another
    model, raises before the target's own requests are touched."""
    kw = dict(replicas=1, n1=N1, slots=3, max_len=64, prefill_len=16,
              policy="ntp", device="cpu")
    session = ServeSession.create(CFG, seed=0, **kw)
    router = Router(session)
    for r in _requests(Request, 2, np.random.default_rng(5), stagger=0):
        router.submit(r)
    router.step()
    path = str(tmp_path / "serve.npz")
    session.save(path, weights=False)
    wide = ArchConfig(**dict(CFG_KW, d_ff=256))
    for other in (ServeSession.create(CFG, seed=9, **kw),
                  ServeSession.create(wide, seed=0, **kw)):
        ro = Router(other)
        ro.submit(Request(rid=77, prompt=np.ones(4, np.int32), max_new=8))
        ro.step()
        with pytest.raises(ValueError, match="other weights"):
            other.restore(path)
        assert other.engines[0].n_active == 1
    same = ServeSession.create(CFG, seed=0, **kw)
    assert same.restore(path) == [] and same.engines[0].n_active == 2


# ---------------------------------------------------------- SLO admission

def test_router_slo_admission_sheds_hopeless_requests():
    """12 requests of 12 tokens against ~2 tokens a tick for 20 ticks: the
    same requests are shed as by the reference, for the same reason, with
    the same `serve.admission` events, and the admitted ones meet their
    deadline."""
    def run(port):
        cls, req, rt = ((ServeSession, Request, Router) if port
                        else (JServeSession, JRequest, JRouter))
        kw = dict(device="cpu") if port else dict(key=jax.random.PRNGKey(0))
        session = cls.create(CFG if port else JCFG, replicas=1, **SMALL_KW,
                             **kw)
        router = rt(session)
        rng = np.random.default_rng(6)
        ok = [router.submit(req(rid=i, prompt=rng.integers(1, 128, 8)
                                .astype(np.int32), max_new=12,
                                deadline=20.0)) for i in range(12)]
        router.drain()
        return ok, router.goodput()

    (jok, jg), jev, (ok, g), tev = _both(run)
    assert ok == jok and 0 < sum(ok) < 12
    assert g["completed"] == sum(ok) and g["rejected"] == 12 - sum(ok)
    assert g["slo_attainment"] >= 0.99
    assert {k: g[k] for k in ("completed", "rejected", "preemptions",
                              "tokens_per_tick", "slo_attainment")} == {
        k: jg[k] for k in ("completed", "rejected", "preemptions",
                           "tokens_per_tick", "slo_attainment")}
    assert tev == jev
    reasons = [dict(e[2]).get("reason") for e in tev
               if e[1] == "serve.admission"]
    assert reasons.count("slo_miss_predicted") == 12 - sum(ok)
    assert reasons.count(None) == sum(ok)
    names = {e[1] for e in tev}
    assert {"serve.ttft", "serve.tpot", "serve.replica_goodput"} <= names


def test_oversize_request_rejected():
    """A request longer than max_len is rejected as ``too_long``; with no
    live replica a deadline request is rejected as ``no_capacity``."""
    def run(port):
        cls, req, rt, ev = ((ServeSession, Request, Router, truntime) if port
                            else (JServeSession, JRequest, JRouter,
                                  jruntime))
        kw = dict(device="cpu") if port else dict(key=jax.random.PRNGKey(0))
        session = cls.create(CFG if port else JCFG, replicas=1,
                             **dict(SMALL_KW, policy="drop"), **kw)
        router = rt(session)
        out = [router.submit(req(rid=0, prompt=np.ones(60, np.int32),
                                 max_new=10))]
        router.apply(ev.FailureEvent(domain=0))
        out.append(router.submit(req(rid=1, prompt=np.ones(4, np.int32),
                                     max_new=4, deadline=50.0)))
        return out, router.rejected

    jout, jev, out, tev = _both(run)
    assert out == jout == ([False, False], 2)
    assert tev == jev
    assert [dict(e[2]).get("reason") for e in tev
            if e[1] == "serve.admission"] == ["too_long", "no_capacity"]


# ------------------------------------------------------- the mixed chain

def _cfgs(arch, **extra):
    """``arch`` reduced in both packages, 4 KV heads (every TP transition
    moves heads over a 4-wide domain)."""
    kw = {"n_heads": 8, "n_kv_heads": 4, **extra}
    if arch == "mamba2-780m":
        kw = extra
    return (dataclasses.replace(jreduced(jget_arch(arch)), **kw),
            dataclasses.replace(reduced(get_arch(arch)), **kw))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=int(rng.integers(4, 15)))
            .astype(np.int32) for _ in range(CHAIN_REQ)]


def chain_parity(jcfg, tcfg, tmp_path):
    """`chip_smoke.DENSE_CHAIN` through the JAX session and the port's on
    the JAX session's weights: streams, transition records and telemetry
    equal; streams equal to an uninterrupted port run; the degradations
    preempt nothing and replica 1 drains over ticks 8-13; the tick-10
    checkpoint restored under TP (4, 3) serves to the same streams.
    Returns the port's run."""
    prompts = _prompts(tcfg.vocab_size)
    saved = {}

    def save(session, router):
        if isinstance(session, ServeSession):
            session.save(str(tmp_path / "chain.npz"))
            saved.update(
                queue=[(r.rid, r.prompt, list(r.generated), r.max_new)
                       for r in router.queue],
                done={r.rid for r in router.completed})

    held = {}

    def run(port):
        if port:
            params = params_from_jax(
                jax.tree.map(np.asarray, held["jax"].params), device="cpu")
            s = ServeSession.create(tcfg, params=params, device="cpu",
                                    **CHAIN_KW)
            rt, req, ev = Router, Request, truntime
        else:
            s = held["jax"] = JServeSession.create(
                jcfg, key=jax.random.PRNGKey(3), **CHAIN_KW)
            rt, req, ev = JRouter, JRequest, jruntime
        return s, chip_smoke.chain_serve(s, rt(s), req, ev, prompts,
                                         max_new=CHAIN_NEW,
                                         per_tick=CHAIN_PER_TICK, save=save)

    (js, jrun), jev, (s, trun), tev = _both(run)
    assert trun["streams"] == jrun["streams"]
    assert len(trun["streams"]) == CHAIN_REQ
    assert _records(s.transitions) == _records(js.transitions)
    assert trun["preempted"] == jrun["preempted"]
    assert trun["admits"] == jrun["admits"]
    assert tev == jev
    assert [e[1] for e in tev].count("serve.transition") == 8

    clean = ServeSession.create(tcfg, params=s.params, device="cpu",
                                **CHAIN_KW)
    want = chip_smoke.chain_serve(clean, Router(clean), Request, truntime,
                                  prompts, max_new=CHAIN_NEW,
                                  per_tick=CHAIN_PER_TICK, chain={})
    chip_smoke.chain_checks(trun, want, CHAIN_REQ, CHAIN_NEW)

    rs = ServeSession.create(tcfg, params=s.params, device="cpu", **CHAIN_KW)
    got, tp, n_pre, restored = chip_smoke.restore_serve(
        rs, Router, Request, truntime, str(tmp_path / "chain.npz"),
        saved["queue"])
    assert tp == (4, 3) and restored
    assert got.keys() == set(want["streams"]) - saved["done"]
    assert all(got[r] == want["streams"][r] for r in got)
    return trun, saved, n_pre


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-780m"])
def test_mixed_chain_equals_jax(arch, tmp_path):
    jcfg, tcfg = _cfgs(arch)
    trun, saved, _ = chain_parity(jcfg, tcfg, tmp_path)
    # the failure preempts, and some requests finish on replica 0 while
    # replica 1 drains: replica 0 admits in the window, replica 1 never
    assert trun["preempted"][0][2] > 0
    window = [a for t, a in trun["admits"] if 8 <= t < 14]
    assert sum(a[0] for a in window) > 0 and sum(a[1] for a in window) == 0
    assert saved["queue"]


def test_chip_chain_is_pinned():
    """`chip_smoke.py` phase 15's chain, sessions and traffic, as its
    docstring and PERF.md state them."""
    kinds = {t: n for t, (n, _) in chip_smoke.DENSE_CHAIN.items()}
    assert kinds == {4: "FailureEvent", 6: "StragglerEvent",
                     8: "SdcSuspectEvent", 10: "save",
                     12: "LinkDegradeEvent", 14: "SdcClearEvent",
                     16: "StragglerClearEvent", 17: "LinkRepairEvent",
                     18: "RecoveryEvent"}
    assert chip_smoke.DENSE_SERVE_KW == dict(
        replicas=2, n1=4, slots=8, max_len=96, prefill_len=32,
        policy="ntp_pw", quarantine=True)
    prompts = chip_smoke.dense_traffic(get_arch("gemma2-9b"))
    assert len(prompts) == 32 and {len(p) for p in prompts} == {24}
    for tick, (name, kw) in chip_smoke.DENSE_CHAIN.items():
        if name != "save":
            getattr(truntime, name)(**kw)     # every event is well formed


# ------------------------------------------------------ analytic goodput

def test_serving_goodput_acceptance_targets():
    """tests/test_serve.py's targets on the port, and every value equal to
    the reference's."""
    from repro.core.availability import ClusterSpec as JSpec
    from repro.core.failure_model import FailureTraceConfig as JTrace
    from repro.serve import blast_radius_goodput as jblast
    from repro.serve import serving_goodput_trace as jtrace
    from repro_torch.core.availability import ClusterSpec
    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.serve import blast_radius_goodput, serving_goodput_trace

    spec = ClusterSpec(n_gpus=32_768, domain_size=32, domains_per_replica=8)
    tc = FailureTraceConfig(n_gpus=spec.n_gpus, domain_size=spec.domain_size,
                            days=15.0, seed=3)
    jspec = JSpec(n_gpus=32_768, domain_size=32, domains_per_replica=8)
    jtc = JTrace(n_gpus=32_768, domain_size=32, days=15.0, seed=3)
    res = serving_goodput_trace(spec, tc)
    assert res == jtrace(jspec, jtc)
    assert res["ntp_pw"]["goodput"] >= 0.95
    assert res["ntp_pw"]["slo_attainment"] >= 0.99
    assert (res["drop"]["goodput"] < res["ntp"]["goodput"]
            < res["ntp_pw"]["goodput"])
    assert res["drop"]["goodput"] < 0.9

    br = blast_radius_goodput(spec, tc, radii=(1, 2, 4, 8))
    assert br == jblast(jspec, jtc, radii=(1, 2, 4, 8))
    drop_loss = [1 - br[d]["drop"] for d in (1, 2, 4, 8)]
    assert all(a < b for a, b in zip(drop_loss, drop_loss[1:]))
    assert drop_loss[3] / drop_loss[0] > 4.0
    assert all(br[d]["ntp_pw"] >= 0.95 for d in (1, 2, 4, 8))


# ---------------------------------------------------------------- launcher

def test_launcher_trace_quarantine_and_telemetry(tmp_path, capsys):
    """The README's CPU lifecycle run: the trace's events as the
    reference's `schedule_from_trace` gives them, every request served,
    and the telemetry stream folded by `launch.telemetry_report` with
    serve percentiles, admissions and one `serve.transition` span an
    applied event."""
    from repro.core.failure_model import FailureTraceConfig as JTrace
    from repro.core.failure_model import parse_trace_mix
    from repro.runtime import event_kind, schedule_from_trace
    from repro_torch.launch import telemetry_report
    from repro_torch.launch.serve import main

    out = tmp_path / "s.jsonl"
    g = main(["--device", "cpu", "--trace", "2e2", "--trace-mix",
              "straggler=1,link=1,sdc=1", "--telemetry", str(out)])
    text = capsys.readouterr().out
    sched = schedule_from_trace(
        JTrace(n_gpus=N1, domain_size=N1, days=5000 / 24.0,
               rate_multiplier=200.0, seed=0,
               **parse_trace_mix("straggler=1,link=1,sdc=1")),
        steps=5000, steps_per_hour=1.0)
    assert f"trace: {len(sched)} events" in text
    applied = [line.split()[3] for line in text.splitlines()
               if line.startswith("*** tick")]
    assert applied == [event_kind(s.event) for s in sched[:len(applied)]]
    assert {"straggler", "link_degrade", "sdc_suspect"} <= set(applied)
    assert "served 60/60" in text and g["completed"] == 60
    assert telemetry.get() is telemetry.NULL     # shut down after the run
    doc = telemetry_report.report(telemetry.load_jsonl(str(out)))
    assert doc["serve"]["admitted"] == 60 and doc["serve"]["rejected"] == 0
    assert doc["serve"]["ttft"]["count"] == 60
    assert doc["serve"]["preempted"] == g["preemptions"] > 0
    spans = sum(r["count"] for k, r in doc["transitions"].items()
                if k.startswith("serve.transition:"))
    assert spans == len(applied)

    main(["--device", "cpu", "--requests", "4", "--max-new", "4",
          "--trace", "2e2", "--quarantine", "off", "--max-ticks", "60",
          "--log-every", "500"])
    assert "served 4/4" in capsys.readouterr().out


@pytest.mark.parametrize("args,match", [
    (["--trace-mix", "sdc=1"], "--trace-mix needs --trace"),
    (["--quarantine", "off"], "--quarantine shapes the trace-driven"),
    (["--trace", "2e2", "--trace-mix", "gpu=1"], "--trace-mix: "),
    (["--quarantine", "maybe"], "invalid choice"),
])
def test_launcher_flag_errors(args, match, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu"] + args)
    assert e.value.code == 2
    assert match in capsys.readouterr().err
