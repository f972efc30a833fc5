"""The port's telemetry (`repro_torch.telemetry`) on the CPU: the recorder,
sink and export semantics of `tests/test_telemetry.py`, the same event
stream as the reference's recorder for the same calls, the event schema of
`tests/golden/telemetry_schema.json`, and the runtime's instrumentation —
session, orchestrator, `measure_sync` and the ``kernels.dispatch`` counter
of the kernel wrappers."""
import json
import os

import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro_torch import telemetry
from repro_torch.telemetry import (
    EVENT_KEYS, EVENT_KINDS, JsonlSink, MemorySink, NULL, NullRecorder,
    Recorder, chrome_trace, load_jsonl, summarize_hist, write_chrome_trace,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "telemetry_schema.json")


class FakeClock:
    """Deterministic monotonic clock: advances only when told to."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt


def make_rec(pkg=telemetry):
    clock = FakeClock()
    sink = pkg.MemorySink()
    return pkg.Recorder(sinks=[sink], clock=clock), sink, clock


# ------------------------------------------------------------------ schema

def test_event_schema_matches_golden():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert sorted(EVENT_KINDS) == golden["event_kinds"]
    assert {k: sorted(v) for k, v in EVENT_KEYS.items()} == \
        golden["event_keys"]


def test_every_event_has_exactly_its_schema_keys():
    rec, sink, clock = make_rec()
    rec.counter("c", 2, a="x")
    rec.gauge("g", 0.5, b="y")
    rec.hist("h", 3.0)
    with rec.span("s", c="z") as sp:
        clock.tick()
        sp.set(k=1).mark("phase")
    evs = {e["kind"]: e for e in sink.events()}
    assert set(evs) == set(EVENT_KINDS)
    for kind, ev in evs.items():
        assert tuple(sorted(ev)) == tuple(sorted(EVENT_KEYS[kind])), kind


def _script(pkg):
    """The same calls on a recorder of ``pkg``; returns its events and the
    Chrome trace of them."""
    rec, sink, clock = make_rec(pkg)
    clock.tick(0.5)
    rec.counter("kernels.dispatch", kernel="rmsnorm", mode="cpu")
    rec.counter("kernels.dispatch", 2, kernel="rmsnorm", mode="cpu")
    rec.gauge("train.goodput", 0.75, policy="ntp_pw")
    rec.hist("serve.ttft", 3.25)
    with rec.span("session.transition", kind="failure", pp=1) as sp:
        clock.tick(0.002)
        sp.mark("planned")
        clock.tick(0.001)
        sp.set(changed=True, bytes_moved=4096)
    with pytest.raises(RuntimeError):
        with rec.span("orchestrator.event", kind="repair"):
            clock.tick(0.25)
            raise RuntimeError("rejected")
    return sink.events(), chrome_trace(sink.events()), rec.total(
        "kernels.dispatch", kernel="rmsnorm", mode="cpu")


def test_same_stream_as_the_reference():
    assert _script(telemetry) == _script(jtel)


# ------------------------------------------------------------- recorder

def test_timestamps_are_recorder_relative():
    rec, sink, clock = make_rec()
    clock.tick(5.0)
    rec.gauge("g", 1.0)
    assert sink.events()[0]["t"] == 5.0


def test_counter_totals_per_labeled_series():
    rec, sink, _ = make_rec()
    assert rec.counter("n", a="x") == 1
    assert rec.counter("n", 2, a="x") == 3
    assert rec.counter("n", a="y") == 1
    assert rec.total("n", a="x") == 3 and rec.total("never") == 0
    assert [e["total"] for e in sink.events(name="n", a="x")] == [1, 3]


def test_span_marks_attrs_duration_and_exception():
    rec, sink, clock = make_rec()
    with rec.span("work", stage="0") as sp:
        clock.tick(2.0)
        sp.mark("planned")
        clock.tick(3.0)
        sp.set(bytes_moved=1024)
    (ev,) = sink.spans("work")
    assert ev["dur"] == 5.0 and ev["labels"] == {"stage": "0"}
    assert ev["attrs"] == {"marks": {"planned": 2.0}, "bytes_moved": 1024}
    with pytest.raises(RuntimeError):
        with rec.span("session.transition") as sp:
            sp.mark("planned")
            clock.tick()
            raise RuntimeError("replica dead")
    (ev,) = sink.spans("session.transition")
    assert ev["dur"] == 1.0 and "changed" not in ev["attrs"]


def test_null_recorder_is_inert():
    assert NULL.enabled is False and isinstance(NULL, NullRecorder)
    assert NULL.counter("x") == 0 and NULL.total("x") == 0
    assert NULL.gauge("x", 1.0) is None and NULL.hist("x", 1.0) is None
    s1, s2 = NULL.span("a"), NULL.span("b", k="v")
    assert s1 is s2
    with NULL.span("x") as sp:
        assert sp.set(a=1) is sp and sp.mark("p") is sp


def test_get_defaults_to_null_and_recording_restores():
    assert telemetry.get() is NULL
    rec, sink, _ = make_rec()
    with telemetry.recording(rec):
        assert telemetry.get() is rec
        telemetry.get().gauge("g", 1.0)
    assert telemetry.get() is NULL and len(sink) == 1
    with pytest.raises(ValueError):
        with telemetry.recording(rec):
            raise ValueError
    assert telemetry.get() is NULL
    with telemetry.recording(rec):
        with telemetry.recording(None):
            assert telemetry.get() is NULL
        assert telemetry.get() is rec
    telemetry.set_active(rec)
    assert telemetry.get() is rec
    telemetry.set_active(None)
    assert telemetry.get() is NULL


def test_configure_and_shutdown(tmp_path):
    path = str(tmp_path / "t.jsonl")
    rec = telemetry.configure(jsonl=path, memory=True)
    try:
        assert telemetry.get() is rec
        rec.gauge("g", 2.0)
        assert rec.values("g") == [2.0]
    finally:
        telemetry.shutdown()
    assert telemetry.get() is NULL
    assert [e["value"] for e in load_jsonl(path)] == [2.0]


# ---------------------------------------------------------------- sinks

def test_jsonl_sink_lazy_open_and_roundtrip(tmp_path):
    path = tmp_path / "out.jsonl"
    rec = Recorder(sinks=[JsonlSink(str(path))], clock=FakeClock())
    assert not path.exists()
    rec.counter("c", a="x")
    with rec.span("s"):
        pass
    rec.close()
    evs = load_jsonl(str(path))
    assert [e["kind"] for e in evs] == ["counter", "span"]
    assert evs[0]["labels"] == {"a": "x"}
    raw = path.read_text().splitlines()[0]
    assert ", " not in raw and ": " not in raw


def test_load_jsonl_names_corrupt_line(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"kind":"gauge"}\n\nnot json\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl:3"):
        load_jsonl(str(path))


def test_memory_sink_ring_and_queries():
    sink = MemorySink(maxlen=3)
    rec = Recorder(sinks=[sink], clock=FakeClock())
    for i in range(5):
        rec.gauge("g", float(i), run="a" if i % 2 == 0 else "b")
    assert len(sink) == 3
    assert sink.values("g") == [2.0, 3.0, 4.0]
    assert sink.values("g", run="b") == [3.0] and sink.values("missing") == []
    with rec.span("sp", run="a"):
        pass
    assert sink.durations("sp", run="a") == [0.0]
    sink.clear()
    assert len(sink) == 0
    with pytest.raises(LookupError, match="MemorySink"):
        Recorder(sinks=[]).values("g")


# --------------------------------------------------------------- export

def test_chrome_trace_mapping(tmp_path):
    rec, sink, clock = make_rec()
    with rec.span("session.step", pp=1) as sp:
        clock.tick(0.002)
        sp.set(bytes_moved=64)
    rec.counter("kernels.dispatch", kernel="rmsnorm")
    rec.counter("kernels.dispatch", kernel="rmsnorm")
    rec.gauge("train.goodput", 0.75, policy="ntp")
    rec.hist("serve.ttft", 3.0)
    doc = chrome_trace(sink.events())
    rows = doc["traceEvents"]
    assert {r["args"]["name"] for r in rows if r["ph"] == "M"} == {"session"}
    (sp_row,) = [r for r in rows if r["ph"] == "X"]
    assert sp_row["dur"] == pytest.approx(2000.0)
    assert sp_row["args"] == {"pp": 1, "bytes_moved": 64}
    tracks = {r["name"]: r["args"]["value"] for r in rows if r["ph"] == "C"}
    assert tracks["kernels.dispatch{kernel=rmsnorm}"] == 2
    assert tracks["train.goodput{policy=ntp}"] == 0.75
    assert not any("ttft" in r["name"] for r in rows)
    path = tmp_path / "trace.json"
    assert write_chrome_trace(str(path), sink.events()) == doc
    assert json.loads(path.read_text()) == doc


def test_summarize_hist_matches_reference():
    assert summarize_hist([]) is None
    vals = [1.0, 2.0, 3.0, 4.0, 10.5]
    assert summarize_hist(vals) == jtel.summarize_hist(vals)
    assert summarize_hist(vals[:4])["p50"] == 2.5


# -------------------------------------------------- runtime instrumentation

def test_kernel_dispatch_counter_counts_wrappers():
    """``kernels.dispatch`` (labels kernel, mode): "cpu" where a wrapper
    takes its plain version, "cuda" where it launches; nothing when off."""
    from repro_torch.kernels import mode
    from repro_torch.kernels.rmsnorm import rmsnorm

    x, w = torch.ones(4, 32), torch.ones(32)
    rec = Recorder(sinks=[MemorySink()])
    with telemetry.recording(rec):
        rmsnorm(x, w)
        rmsnorm(x, w)
        mode.count_launch("bucket_pack")
    assert rec.total("kernels.dispatch", kernel="rmsnorm", mode="cpu") == 2
    assert rec.total("kernels.dispatch", kernel="bucket_pack",
                      mode="cuda") == 1
    ev = rec.sinks[0].events(kind="counter", name="kernels.dispatch")[0]
    assert set(ev["labels"]) == {"kernel", "mode"}
    n = len(rec.sinks[0])
    rmsnorm(x, w)
    assert len(rec.sinks[0]) == n


def _session(**kw):
    from repro_torch.core import ntp_train as nt
    from repro_torch.optim import sgd
    from repro_torch.runtime import NTPSession

    cfg = nt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=2,
                            head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                            n_layers=2)
    return NTPSession.create(
        cfg, (2, 4), local_batch=4, optimizer=sgd(0.05), device="cpu",
        params=nt.init_canonical(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"), **kw)


def _batch(i):
    rng = np.random.default_rng(i)
    return rng.integers(0, 128, (8, 17))


def test_session_transition_span_carries_the_ledger():
    from repro_torch.runtime import (
        FailureEvent, StragglerEvent, power_policy,
    )

    s = _session(power_policy=power_policy("ntp_pw"))
    rec = Recorder(sinks=[MemorySink()])
    with telemetry.recording(rec):
        s.step(_batch(0))
        s.apply(FailureEvent(replica=1))
        s.apply(StragglerEvent(domain=0, slowdown=1.5))
        s.step(_batch(1))
    fail, strag = rec.spans("session.transition")
    assert fail["labels"] == {"kind": "failure", "pp": 1}
    assert set(fail["attrs"]["marks"]) == {"planned", "executed"}
    for k, v in s.last_transition.as_dict().items():
        assert fail["attrs"][k] == v
    assert rec.values("cluster.transition_bytes") == \
        [s.last_transition.bytes_moved]
    assert strag["attrs"]["changed"] is False and strag["attrs"]["degraded"]
    assert len(rec.spans("session.step")) == 2
    assert rec.values("train.power_boost", policy="ntp_pw") == [1.3]
    assert len(rec.values("train.rel_iter_time", policy="ntp_pw")) == 1


def test_runner_goodput_gauges_fold_to_goodput():
    from repro_torch.runtime import (
        FailureEvent, ScheduledEvent, SdcClearEvent, SdcSuspectEvent,
        TraceRunner,
    )

    s = _session()
    sched = [ScheduledEvent(1, FailureEvent(step=1, domain=1)),
             ScheduledEvent(2, SdcSuspectEvent(step=2, domain=0)),
             ScheduledEvent(3, SdcClearEvent(step=3, domain=0))]
    runner = TraceRunner(s, sched)
    rec = Recorder(sinks=[MemorySink()])
    with telemetry.recording(rec):
        runner.run(_batch, 4)
    vals = rec.values("train.goodput", policy="none")
    # TP (3, 4) under NTP keeps 3 + 4 of 8 samples; the SDC on domain 0
    # (replica 1 after packing) quarantines 4 of them
    assert vals == [1.0, 0.875, 0.375, 0.875]
    assert float(np.mean(vals)) == runner.goodput()
    assert rec.values("train.goodput_unboosted", policy="none") == \
        [1.0, 0.875, 0.875, 0.875]
    assert rec.values("train.goodput_degradation_loss", policy="none") == \
        [0.0, 0.0, 0.5, 0.0]
    assert rec.total("orchestrator.events", kind="sdc_suspect") == 1
    ev = [e for e in rec.spans("orchestrator.event")
          if e["labels"]["kind"] == "sdc_suspect"][0]
    assert ev["attrs"]["rollback"] is True
    assert set(ev["attrs"]["marks"]) == {"plan", "execute"}
    # the off path records nothing
    quiet = Recorder(sinks=[MemorySink()])
    TraceRunner(_session(), sched).run(_batch, 2)
    assert len(quiet.sinks[0]) == 0


@pytest.mark.parametrize("overlap", [False, True])
def test_measure_sync_span(overlap):
    with open(GOLDEN) as f:
        sync_keys = set(json.load(f)["train_sync_keys"]) - {"count"}
    s = _session(overlap=overlap)
    rec = Recorder(sinks=[MemorySink()])
    with telemetry.recording(rec):
        out = s.measure_sync(_batch(0))
    (sp,) = rec.spans("train.sync")
    assert sync_keys <= set(sp["attrs"])
    assert sp["labels"] == {"overlap": "on" if overlap else "off",
                            "backend": "ntp"}
    assert set(sp["attrs"]["marks"]) == {"issued", "completed"}
    assert out["collectives"] == s.step_fn.collectives
    assert out["sync_s"] == out["exposed_s"] > 0
