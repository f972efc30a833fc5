"""The port's offline telemetry fold (`repro_torch.launch.telemetry_report`)
against the reference's (`repro.launch.telemetry_report`):

* on the reference's synthetic streams (tests/test_telemetry_report.py's
  `build_stream`, and streams of lifecycle counters, SDC rollbacks,
  degradation losses, sync probes and serve series recorded by the port's
  `Recorder`) every table equals the reference's; the kernel table folds
  the port's own dispatch modes, ``cuda`` and ``cpu``;
* a real JSONL stream of the port's launcher (``--trace ... --pp 2
  --spares 1 --allocator greedy`` on the CPU) folds, through both reports,
  to equal goodput, lifecycle-event and transition tables, and its
  (predicted, executed) transition byte pairs are equal;
* the CLI writes ``--json`` and ``--perfetto``.
"""
import importlib.util
import json
import os

import pytest
import torch

from repro.launch import telemetry_report as jrep
from repro_torch import telemetry
from repro_torch.launch import telemetry_report as trep

TABLES = ("goodput_table", "events_table", "transition_table", "sync_table",
          "serve_table")


def _reference_tests():
    path = os.path.join(os.path.dirname(__file__), "test_telemetry_report.py")
    spec = importlib.util.spec_from_file_location("_ref_report_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The launcher's model is tiny: one intra-op thread runs it as fast as
    eight, and keeps it from spinning against the other test workers'
    threads on a shared CPU. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mixed_stream():
    """Lifecycle counters, an SDC rollback, degradation losses, sync probes
    of both overlap modes, serve series and kernel dispatches, on a
    stepped clock (the port's Recorder)."""
    clock = REF.StreamClock()
    sink = telemetry.MemorySink()
    rec = telemetry.Recorder(sinks=[sink], clock=clock)
    for kind, n in (("failure", 2), ("straggler", 3), ("sdc_suspect", 1),
                    ("repair", 1)):
        for _ in range(n):
            rec.counter("orchestrator.events", kind=kind)
    with rec.span("session.transition", kind="sdc_suspect") as sp:
        clock.t += 0.01
        sp.set(changed=False, degraded=True, rollback=True)
    with rec.span("session.transition", kind="failure", pp=2) as sp:
        clock.t += 0.3
        sp.set(changed=True, bytes_moved=688128, messages=6)
    for pol, loss in (("ntp", 0.0), ("ntp", 0.25), ("ntp_pw", 0.125)):
        with rec.span("session.step", backend="ntp"):
            clock.t += 0.1
        rec.gauge("train.goodput", 1.0 - loss, policy=pol)
        rec.gauge("train.goodput_unboosted", 1.0 - 2 * loss, policy=pol)
        rec.gauge("train.goodput_degradation_loss", loss, policy=pol)
        rec.gauge("train.rel_iter_time", 1.0 + loss, source="analytic",
                  policy=pol)
    for overlap, coll, sync, exposed in (("off", 48, 0.04, 0.04),
                                         ("on", 8, 0.01, 0.002),
                                         ("on", 8, 0.012, 0.003)):
        with rec.span("train.sync", overlap=overlap, backend="ntp") as sp:
            clock.t += sync
            sp.set(collectives=coll, sync_s=sync, exposed_s=exposed)
    for v in (2.0, 4.0, 9.0):
        rec.hist("serve.ttft", v)
    rec.hist("serve.tpot", 1.0)
    rec.counter("serve.admission", 3, outcome="admitted")
    rec.counter("serve.admission", outcome="rejected", reason="too_long")
    rec.counter("serve.preempted", 2, policy="ntp")
    rec.counter("kernels.dispatch", kernel="rmsnorm", mode="cpu")
    rec.counter("kernels.dispatch", kernel="rmsnorm", mode="cpu")
    rec.counter("kernels.dispatch", kernel="reshard_pack", mode="cuda")
    return list(sink.events())


def _streams():
    return {
        "build_stream": list(REF.build_stream()[1].events()),
        "overdrive": list(REF.build_stream(rel=(0.9,) * 4)[1].events()),
        "mixed": _mixed_stream(),
        "empty": [],
    }


@pytest.mark.parametrize("name", ["build_stream", "overdrive", "mixed",
                                  "empty"])
def test_tables_match_reference(name):
    events = _streams()[name]
    for table in TABLES:
        assert getattr(trep, table)(events) == getattr(jrep, table)(events), \
            table
    got, want = trep.report(events), jrep.report(events)
    got.pop("kernels", None)
    want.pop("kernels", None)
    assert got == want
    assert trep.GOODPUT_KEYS == jrep.GOODPUT_KEYS
    assert trep.SYNC_SPAN_KEYS == jrep.SYNC_SPAN_KEYS


def test_kernel_table_folds_the_port_modes():
    events = _mixed_stream()
    assert trep.kernel_table(events) == {
        "rmsnorm": {"cuda": 0, "cpu": 2}, "reshard_pack": {"cuda": 1,
                                                           "cpu": 0}}
    assert trep.report(events)["kernels"] == trep.kernel_table(events)
    assert trep.report([]) == {"events": 0}


def test_transition_bytes_pairs():
    """A predicted gauge pairs with the next executed one; a replan that
    moved nothing leaves its predicted gauge unpaired; an executed
    transition without a verdict before it pairs with None."""
    rec = telemetry.Recorder(sinks=[telemetry.MemorySink()])
    for predicted, executed in ((0, None), (4096, 4096), (0, None),
                                (1024, 1024)):
        rec.gauge("cluster.transition_bytes", predicted, source="predicted")
        if executed is not None:
            rec.gauge("cluster.transition_bytes", executed, source="executed")
    rec.gauge("cluster.transition_bytes", 7, source="executed")
    events = list(rec.sinks[0].events())
    assert trep.transition_bytes_table(events) == [
        {"predicted": 4096, "executed": 4096},
        {"predicted": 1024, "executed": 1024},
        {"predicted": None, "executed": 7}]
    assert trep.report(events)["transition_bytes"] == \
        trep.transition_bytes_table(events)


def test_launcher_stream_folds_like_the_reference(tmp_path, capsys):
    """A real stream of the port's launcher with the allocator at pp=2:
    both reports fold it to equal goodput, lifecycle-event and transition
    tables; the CLI writes its JSON report and a Perfetto trace."""
    from repro_torch.launch.train import main as train

    path = str(tmp_path / "run.jsonl")
    train(["--ntp", "--device", "cpu", "--pp", "2", "--spares", "1",
           "--allocator", "greedy", "--steps", "8", "--trace", "200",
           "--trace-seed", "136", "--seq-len", "16", "--batch", "2",
           "--log-every", "4", "--telemetry", path])
    events = telemetry.load_jsonl(path)
    got, want = trep.report(events), jrep.report(events)
    for key in ("goodput", "lifecycle_events", "transitions"):
        assert got[key] == want[key], key
    assert sum(got["lifecycle_events"].values()) > 0
    assert any(k.endswith(":executed") for k in got["transitions"])
    pairs = got["transition_bytes"]
    assert pairs and all(p["predicted"] == p["executed"] for p in pairs)
    assert got["kernels"]["reshard_pack"]["cuda"] == 0
    capsys.readouterr()
    out_json, out_trace = str(tmp_path / "r.json"), str(tmp_path / "t.json")
    trep.main([path, "--json", out_json, "--perfetto", out_trace])
    text = capsys.readouterr().out
    assert "goodput decomposition:" in text
    assert "transition bytes (allocator predicted / executed):" in text
    with open(out_json) as f:
        assert json.load(f) == json.loads(json.dumps(got, sort_keys=True))
    with open(out_trace) as f:
        assert len(json.load(f)["traceEvents"]) > 0
