"""Exports: JSONL loading, Chrome-trace/Perfetto conversion, histogram
summaries (the port's copy of `repro/telemetry/export.py`).

The Chrome trace format (loadable by ``chrome://tracing`` and Perfetto's
trace viewer) maps:

* span events → ``ph: "X"`` complete events (``ts``/``dur`` in µs on the
  recorder's monotonic clock; labels + attrs land in ``args``, so a
  transition span carries its `TransferStats` byte counts into the UI);
* gauge/counter events → ``ph: "C"`` counter tracks (one named track per
  series, labels folded into the track name).

Rows are grouped into one process (pid 0) with the event name's dotted
prefix (``session.``, ``serve.``, ``orchestrator.``…) as the thread name,
so each subsystem gets its own swimlane.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

import numpy as np


def load_jsonl(path: str) -> List[Dict]:
    """Parse one recorder JSONL stream; blank lines are skipped, any other
    parse failure raises (a telemetry file is append-only JSON lines — a
    corrupt line means the run died mid-write and the caller should know)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not a JSON event: {e}")
    return out


def _track(name: str, labels: Dict) -> str:
    if not labels:
        return name
    lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{lbl}}}"


def chrome_trace(events: Iterable[Dict]) -> Dict:
    """Convert recorder events into a Chrome-trace JSON object (the
    ``chrome://tracing`` / Perfetto 'JSON trace' format)."""
    rows: List[Dict] = []
    tids: Dict[str, int] = {}

    def tid(name: str) -> int:
        group = name.split(".", 1)[0]
        if group not in tids:
            tids[group] = len(tids)
            rows.append({
                "name": "thread_name", "ph": "M", "pid": 0,
                "tid": tids[group], "args": {"name": group},
            })
        return tids[group]

    for ev in events:
        if ev["kind"] == "span":
            rows.append({
                "name": ev["name"], "cat": ev["kind"], "ph": "X",
                "ts": round(ev["t0"] * 1e6, 3),
                "dur": round(ev["dur"] * 1e6, 3),
                "pid": 0, "tid": tid(ev["name"]),
                "args": {**ev.get("labels", {}), **ev.get("attrs", {})},
            })
        elif ev["kind"] in ("gauge", "counter"):
            track = _track(ev["name"], ev.get("labels", {}))
            value = ev["total"] if ev["kind"] == "counter" else ev["value"]
            rows.append({
                "name": track, "cat": ev["kind"], "ph": "C",
                "ts": round(ev["t"] * 1e6, 3), "pid": 0,
                "args": {"value": value},
            })
        # hist events have no Chrome-trace counterpart (they aggregate at
        # report time); skipped by design
    return {"traceEvents": rows, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: Iterable[Dict]) -> Dict:
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def summarize_hist(values: List[float]) -> Optional[Dict]:
    """count/mean/p50/p95/p99/max of one histogram series (None if empty)."""
    if not values:
        return None
    v = np.asarray(values, dtype=float)
    return {
        "count": int(v.size),
        "mean": float(v.mean()),
        "p50": float(np.percentile(v, 50)),
        "p95": float(np.percentile(v, 95)),
        "p99": float(np.percentile(v, 99)),
        "max": float(v.max()),
    }
