"""Offline telemetry folding: JSONL stream → goodput-decomposition table
(+ optional Perfetto trace); port of `repro/launch/telemetry_report.py`.

The recorder stream is lossless, so everything here is arithmetic over the
recorded events; nothing is re-simulated:

* **goodput table** (per power policy, from the `train.goodput` /
  `train.goodput_unboosted` gauge series the orchestrator records with the
  SAME local-batch arithmetic as `TraceRunner.goodput()` — the folded mean
  matches the runner's own accounting exactly);
* **time decomposition** — ``compute / bubble / reshard / exposed-comm``
  fractions of the run, from the `session.step` / `session.transition`
  span durations, the per-step `train.rel_iter_time` gauges (steps with no
  recorded slowdown count as rel 1.0), and the `train.sync` probe spans'
  ``exposed_s`` attrs (pre-overlap traces carry no sync spans and report
  ``exposed_comm_frac = 0.0`` — old streams re-fold unchanged);
* **sync table** — per overlap mode (`on`/`off`), collective-launch counts
  and total/exposed sync seconds from the `train.sync` spans that
  `NTPSession.measure_sync` records (DESIGN.md §2.10);
* **lifecycle-event table** — per-kind event totals (§2.11 taxonomy:
  failure/repair plus straggler/link/sdc onsets and clears) from the
  `orchestrator.events` counter, with SDC rollback executions from the
  transition spans; the goodput rows carry the matching
  ``degradation_loss`` slice (goodput lost to the degradation ledger
  beyond GPU absence);
* **transition table** — per-kind counts and byte totals from the
  transition spans' attached `TransferStats`;
* **serve table** — TTFT/TPOT percentile summaries + admission/preemption
  totals, when serve events are present;
* **transition-bytes table** — the allocator's predicted bytes beside the
  session's executed bytes of each executed transition, from the paired
  ``cluster.transition_bytes`` gauges (``source="predicted"`` /
  ``"executed"``);
* **kernel table** — dispatch totals per kernel and mode. The port's
  kernels count ``kernels.dispatch`` with ``mode="cuda"`` (a launch) or
  ``mode="cpu"`` (the plain version on CPU tensors), not the reference's
  ``compiled`` / ``interpret``: the table folds the port's own modes.

CLI::

  python -m repro_torch.launch.telemetry_report run.jsonl
  python -m repro_torch.launch.telemetry_report run.jsonl --perfetto trace.json
  python -m repro_torch.launch.telemetry_report run.jsonl --json report.json
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.telemetry import (
    load_jsonl, summarize_hist, write_chrome_trace,
)

# the goodput-decomposition row schema (the reference's, guarded with
# EVENT_KEYS by the golden in tests/golden/telemetry_schema.json)
GOODPUT_KEYS = (
    "steps", "goodput", "goodput_unboosted", "boost_recovered",
    "degradation_loss", "compute_frac", "bubble_frac", "reshard_frac",
    "exposed_comm_frac",
)

# the per-overlap-mode sync row schema (train.sync spans)
SYNC_SPAN_KEYS = ("count", "collectives", "sync_s", "exposed_s")


def _series(events: Iterable[Dict], kind: str, name: str,
            label: Optional[Dict] = None) -> List[Dict]:
    label = label or {}
    return [
        e for e in events
        if e["kind"] == kind and e["name"] == name
        and all(e.get("labels", {}).get(k) == v for k, v in label.items())
    ]


def goodput_table(events: List[Dict]) -> Dict[str, Dict]:
    """One decomposition row per power policy seen in the stream.

    ``goodput`` is the mean of the recorded per-step `train.goodput` gauges
    — identical, by construction, to the orchestrator's own
    ``TraceRunner.goodput()`` (same per-step sums, same mean).
    ``boost_recovered`` is the goodput the power boost bought back relative
    to the unboosted local-batch rule on the same plans. The time fractions
    split the run's wall clock: ``reshard_frac`` from transition span
    durations, ``bubble_frac`` from the predicted per-step slowdown on the
    remaining step time, ``exposed_comm_frac`` from the `train.sync` probe
    spans' ``exposed_s`` attrs (gradient sync left on the critical path —
    zero when the trace predates the overlap engine), ``compute_frac`` as
    the rest."""
    step_spans = _series(events, "span", "session.step")
    # only transitions that EXECUTED moved any state; refused/no-op applies
    # are planner overhead, not reshard traffic
    trans_spans = [e for e in _series(events, "span", "session.transition")
                   if e["attrs"].get("changed") is True]
    sync_spans = _series(events, "span", "train.sync")
    step_s = float(sum(e["dur"] for e in step_spans))
    reshard_s = float(sum(e["dur"] for e in trans_spans))
    exposed_s = float(sum(e["attrs"].get("exposed_s", 0.0)
                          for e in sync_spans))
    denom = step_s + reshard_s
    reshard_frac = reshard_s / denom if denom > 0 else 0.0
    exposed_frac = min(exposed_s / denom, 1.0 - reshard_frac) \
        if denom > 0 else 0.0

    out: Dict[str, Dict] = {}
    policies = sorted({
        e["labels"]["policy"]
        for e in _series(events, "gauge", "train.goodput")
    })
    for pol in policies:
        g = [e["value"] for e in
             _series(events, "gauge", "train.goodput", {"policy": pol})]
        gu = [e["value"] for e in
              _series(events, "gauge", "train.goodput_unboosted",
                      {"policy": pol})]
        rel = [e["value"] for e in
               _series(events, "gauge", "train.rel_iter_time",
                       {"source": "analytic"})]
        # degraded steps record their predicted slowdown; healthy steps
        # record nothing — pad to the step count at rel 1.0. A boosted
        # policy can predict rel < 1 (overdrive); that is boost territory,
        # not bubble, so the bubble floor is 0 per step.
        n = max(len(g), len(step_spans))
        rel = rel[:n] + [1.0] * max(0, n - len(rel))
        bubble = (float(np.mean([1.0 - 1.0 / max(r, 1.0) for r in rel]))
                  if rel else 0.0)
        bubble_frac = (1.0 - reshard_frac) * bubble
        # exposed comm comes out of the compute share (it is step time the
        # backward window failed to hide); never let it push compute < 0
        ef = min(exposed_frac, 1.0 - reshard_frac - bubble_frac)
        goodput = float(np.mean(g)) if g else 1.0
        goodput_u = float(np.mean(gu)) if gu else goodput
        # degradation-attributed loss (§2.11): per-step goodput the ledger
        # cost beyond binary TP reductions — straggle/link repricing and
        # quarantined replicas. Old streams carry no such gauges and fold
        # to 0.0 (no degradation observed).
        dl = [e["value"] for e in
              _series(events, "gauge", "train.goodput_degradation_loss",
                      {"policy": pol})]
        out[pol] = {
            "steps": len(g),
            "goodput": goodput,
            "goodput_unboosted": goodput_u,
            "boost_recovered": goodput - goodput_u,
            "degradation_loss": float(np.mean(dl)) if dl else 0.0,
            "compute_frac": 1.0 - reshard_frac - bubble_frac - ef,
            "bubble_frac": bubble_frac,
            "reshard_frac": reshard_frac,
            "exposed_comm_frac": ef,
        }
    return out


def events_table(events: List[Dict]) -> Dict[str, int]:
    """Per-kind lifecycle event totals from the orchestrator's
    ``orchestrator.events`` counter — the §2.11 taxonomy (failure/repair
    plus straggler/link/sdc onsets and clears), with SDC rollback
    executions folded in from the ``session.transition`` spans' rollback
    attr. Binary-era streams fold to failure/repair rows only."""
    out: Dict[str, int] = {}
    for e in _series(events, "counter", "orchestrator.events"):
        kind = e["labels"].get("kind", "?")
        out[kind] = out.get(kind, 0) + int(e["value"])
    rollbacks = sum(
        1 for e in _series(events, "span", "session.transition")
        if e["attrs"].get("rollback") is True
    )
    if rollbacks:
        out["sdc_rollback"] = rollbacks
    return out


def transition_table(events: List[Dict]) -> Dict[str, Dict]:
    """Per-kind transition counts + byte/message totals from the span-borne
    `TransferStats` (train `session.transition` and serve
    `serve.transition` both land here)."""
    out: Dict[str, Dict] = {}
    for name in ("session.transition", "serve.transition"):
        for e in _series(events, "span", name):
            kind = e["labels"].get("kind", "?")
            # a train span without a "changed" attr never finished apply():
            # the session refused the event (DeadReplicaError) mid-span
            if name == "session.transition":
                changed = e["attrs"].get("changed")
                outcome = ("executed" if changed is True
                           else "noop" if changed is False else "rejected")
            else:
                outcome = "executed"
            row = out.setdefault(f"{name}:{kind}:{outcome}", {
                "count": 0, "bytes_moved": 0, "messages": 0, "seconds": 0.0,
            })
            row["count"] += 1
            row["bytes_moved"] += int(e["attrs"].get("bytes_moved", 0))
            row["messages"] += int(e["attrs"].get("messages", 0))
            row["seconds"] += float(e["dur"])
    return out


def sync_table(events: List[Dict]) -> Dict[str, Dict]:
    """Per-overlap-mode gradient-sync rollup from the `train.sync` probe
    spans (`NTPSession.measure_sync`, DESIGN.md §2.10): probe counts, the
    static collective-launch count of the compiled sync, and total /
    exposed sync seconds. Row keys are guarded by ``SYNC_SPAN_KEYS`` in the
    telemetry schema golden."""
    out: Dict[str, Dict] = {}
    for e in _series(events, "span", "train.sync"):
        mode = e["labels"].get("overlap", "?")
        row = out.setdefault(mode, {
            "count": 0, "collectives": 0, "sync_s": 0.0, "exposed_s": 0.0,
        })
        row["count"] += 1
        # static per-step launch count — identical across probes of one mode
        row["collectives"] = int(e["attrs"].get("collectives",
                                                row["collectives"]))
        row["sync_s"] += float(e["attrs"].get("sync_s", e["dur"]))
        row["exposed_s"] += float(e["attrs"].get("exposed_s", 0.0))
    return out


def serve_table(events: List[Dict]) -> Optional[Dict]:
    ttft = [e["value"] for e in _series(events, "hist", "serve.ttft")]
    tpot = [e["value"] for e in _series(events, "hist", "serve.tpot")]
    admission = _series(events, "counter", "serve.admission")
    preempted = _series(events, "counter", "serve.preempted")
    if not (ttft or tpot or admission or preempted):
        return None
    return {
        "ttft": summarize_hist(ttft),
        "tpot": summarize_hist(tpot),
        "admitted": sum(e["value"] for e in admission
                        if e["labels"].get("outcome") == "admitted"),
        "rejected": sum(e["value"] for e in admission
                        if e["labels"].get("outcome") == "rejected"),
        "preempted": sum(e["value"] for e in preempted),
    }


def transition_bytes_table(events: List[Dict]) -> List[Dict[str, int]]:
    """One ``{"predicted", "executed"}`` row per executed transition: each
    ``cluster.transition_bytes`` gauge with ``source="executed"`` (the
    session's ledger) beside the latest ``source="predicted"`` one before it
    (the allocator's verdict on the same event). An executed transition
    with no verdict before it (no allocator) has ``predicted`` None."""
    rows: List[Dict[str, int]] = []
    predicted = None
    for e in _series(events, "gauge", "cluster.transition_bytes"):
        source = e["labels"].get("source")
        if source == "predicted":
            predicted = int(e["value"])
        elif source == "executed":
            rows.append({"predicted": predicted, "executed": int(e["value"])})
            predicted = None
    return rows


def kernel_table(events: List[Dict]) -> Dict[str, Dict[str, int]]:
    """Dispatch totals per kernel: launches (``cuda``) and plain-version
    calls on CPU tensors (``cpu``)."""
    out: Dict[str, Dict[str, int]] = {}
    for e in _series(events, "counter", "kernels.dispatch"):
        k = e["labels"].get("kernel", "?")
        mode = e["labels"].get("mode", "?")
        out.setdefault(k, {"cuda": 0, "cpu": 0})
        out[k][mode] = out[k].get(mode, 0) + int(e["value"])
    return out


def report(events: List[Dict]) -> Dict:
    """The full folded report (every table; empty sections omitted)."""
    doc: Dict = {"events": len(events)}
    gp = goodput_table(events)
    if gp:
        doc["goodput"] = gp
    le = events_table(events)
    if le:
        doc["lifecycle_events"] = le
    tr = transition_table(events)
    if tr:
        doc["transitions"] = tr
    sy = sync_table(events)
    if sy:
        doc["sync"] = sy
    sv = serve_table(events)
    if sv is not None:
        doc["serve"] = sv
    tb = transition_bytes_table(events)
    if tb:
        doc["transition_bytes"] = tb
    kt = kernel_table(events)
    if kt:
        doc["kernels"] = kt
    return doc


def _print_report(doc: Dict) -> None:
    print(f"telemetry events: {doc['events']}")
    if "goodput" in doc:
        hdr = f"{'policy':10s}" + "".join(f"{k:>18s}" for k in GOODPUT_KEYS)
        print("\ngoodput decomposition:\n" + hdr)
        for pol, row in doc["goodput"].items():
            cells = "".join(
                f"{row[k]:18d}" if isinstance(row[k], int)
                else f"{row[k]:18.4f}" for k in GOODPUT_KEYS
            )
            print(f"{pol:10s}{cells}")
    if "lifecycle_events" in doc:
        print("\nlifecycle events:")
        for kind, n in sorted(doc["lifecycle_events"].items()):
            print(f"  {kind:18s} {n:6d}")
    if "transitions" in doc:
        print("\ntransitions:")
        for k, row in sorted(doc["transitions"].items()):
            print(f"  {k:28s} count {row['count']:4d}  "
                  f"bytes {row['bytes_moved']:>12,d}  "
                  f"msgs {row['messages']:5d}  {row['seconds']*1e3:8.1f} ms")
    if "sync" in doc:
        print("\ngradient sync (train.sync probes):")
        for mode, row in sorted(doc["sync"].items()):
            print(f"  overlap {mode:4s} probes {row['count']:3d}  "
                  f"collectives {row['collectives']:4d}  "
                  f"sync {row['sync_s']*1e3:8.1f} ms  "
                  f"exposed {row['exposed_s']*1e3:8.1f} ms")
    if "serve" in doc:
        sv = doc["serve"]
        print("\nserve:")
        for h in ("ttft", "tpot"):
            s = sv[h]
            if s:
                print(f"  {h}: n {s['count']:5d}  mean {s['mean']:.2f}  "
                      f"p50 {s['p50']:.2f}  p95 {s['p95']:.2f}  "
                      f"p99 {s['p99']:.2f}")
        print(f"  admitted {sv['admitted']:.0f}  rejected {sv['rejected']:.0f}"
              f"  preempted {sv['preempted']:.0f}")
    if "transition_bytes" in doc:
        print("\ntransition bytes (allocator predicted / executed):")
        for row in doc["transition_bytes"]:
            print(f"  predicted {row['predicted']}  executed "
                  f"{row['executed']}")
    if "kernels" in doc:
        print("\nkernel dispatch:")
        for k, row in sorted(doc["kernels"].items()):
            print(f"  {k:20s} cuda {row.get('cuda', 0):6d}  "
                  f"cpu {row.get('cpu', 0):6d}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl", help="recorder JSONL stream (--telemetry output)")
    ap.add_argument("--perfetto", default=None, metavar="TRACE.json",
                    help="also write a Chrome-trace/Perfetto JSON trace")
    ap.add_argument("--json", default=None, metavar="REPORT.json",
                    help="also write the folded report as JSON")
    args = ap.parse_args(argv)
    events = load_jsonl(args.jsonl)
    doc = report(events)
    _print_report(doc)
    if args.perfetto:
        trace = write_chrome_trace(args.perfetto, events)
        print(f"\nperfetto trace ({len(trace['traceEvents'])} rows) -> "
              f"{args.perfetto}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"report json -> {args.json}")


if __name__ == "__main__":
    main()
