"""The recorder: one structured-observability surface for the whole runtime
(the port's copy of `repro/telemetry/recorder.py`).

Three primitives, one event stream:

* **counter** — monotonically accumulating count per (name, labels) series;
  every increment is emitted with the running ``total`` so a JSONL stream
  can be cut at any point and still read absolutely.
* **gauge** — a sampled value per (name, labels) series (goodput,
  rel_iter_time, power boost, per-replica rates).
* **hist** — raw observations (TTFT, TPOT, plan latencies); aggregation
  (count/mean/p50/p99) happens at read time (`summarize`), never at record
  time, so the stream stays lossless.
* **span** — a timed region (``with rec.span("session.step"): ...``) on the
  monotonic clock, with attachable attributes (`Span.set`) and intermediate
  phase marks (`Span.mark` — arrival→plan→execute→verified lifecycles).

Events are plain dicts pushed to pluggable sinks (telemetry/sinks.py); the
schema is FIXED per kind (`EVENT_KEYS`, guarded by the golden in
tests/golden/telemetry_schema.json):

* counter: ``{t, kind, name, value, total, labels}``
* gauge:   ``{t, kind, name, value, labels}``
* hist:    ``{t, kind, name, value, labels}``
* span:    ``{t0, t1, dur, kind, name, labels, attrs}``

Timestamps are seconds on ``time.perf_counter`` relative to the recorder's
creation (monotonic — wall-clock jumps never corrupt durations); the clock
is injectable for deterministic tests.

The **off path is the null recorder** (`NULL`): every method is a no-op and
``enabled`` is False, so instrumented code guarded by ``telemetry.get()``
adds a dict lookup and a no-op call — nothing else. Recorder-off behavior
is bit-identical to uninstrumented code by construction (no device syncs,
no numerics anywhere in this module).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

EVENT_KINDS = ("counter", "gauge", "hist", "span")

# the fixed JSONL schema per event kind (tests/golden/telemetry_schema.json)
EVENT_KEYS = {
    "counter": ("t", "kind", "name", "value", "total", "labels"),
    "gauge": ("t", "kind", "name", "value", "labels"),
    "hist": ("t", "kind", "name", "value", "labels"),
    "span": ("t0", "t1", "dur", "kind", "name", "labels", "attrs"),
}


def _series_key(name: str, labels: Dict) -> Tuple:
    return (name,) + tuple(sorted(labels.items()))


class Span:
    """One timed region. Created by `Recorder.span`; emits its event on
    ``__exit__``. ``set(**attrs)`` attaches attributes (e.g. the transition
    ledger's byte counts), ``mark(phase)`` records the phase's offset from
    span start into ``attrs["marks"]``."""

    __slots__ = ("_rec", "name", "labels", "attrs", "t0", "t1")

    def __init__(self, rec: "Recorder", name: str, labels: Dict):
        self._rec = rec
        self.name = name
        self.labels = labels
        self.attrs: Dict = {}
        self.t0 = None
        self.t1 = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def mark(self, phase: str) -> "Span":
        marks = self.attrs.setdefault("marks", {})
        marks[phase] = round(self._rec._now() - self.t0, 9)
        return self

    def __enter__(self) -> "Span":
        self.t0 = self._rec._now()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self._rec._now()
        self._rec._emit({
            "t0": round(self.t0, 9), "t1": round(self.t1, 9),
            "dur": round(self.t1 - self.t0, 9),
            "kind": "span", "name": self.name,
            "labels": self.labels, "attrs": self.attrs,
        })


class _NullSpan:
    """Reusable no-op span (the off path). Stateless, so one singleton
    serves every ``with`` block."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def mark(self, phase: str) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Recorder:
    """Counters + gauges + histograms + spans over pluggable sinks."""

    enabled = True

    def __init__(self, sinks: Iterable = (), *,
                 clock: Callable[[], float] = time.perf_counter,
                 meta: Optional[Dict] = None):
        self.sinks = list(sinks)
        self._clock = clock
        self._t0 = clock()
        self._totals: Dict[Tuple, float] = {}
        self.meta = dict(meta or {})

    # ------------------------------------------------------------- recording

    def _now(self) -> float:
        return self._clock() - self._t0

    def _emit(self, event: Dict) -> None:
        for s in self.sinks:
            s.write(event)

    def counter(self, name: str, value: float = 1, **labels) -> float:
        """Increment the (name, labels) series; returns the running total."""
        key = _series_key(name, labels)
        total = self._totals.get(key, 0) + value
        self._totals[key] = total
        self._emit({"t": round(self._now(), 9), "kind": "counter",
                    "name": name, "value": value, "total": total,
                    "labels": labels})
        return total

    def gauge(self, name: str, value: float, **labels) -> None:
        self._emit({"t": round(self._now(), 9), "kind": "gauge",
                    "name": name, "value": value, "labels": labels})

    def hist(self, name: str, value: float, **labels) -> None:
        self._emit({"t": round(self._now(), 9), "kind": "hist",
                    "name": name, "value": value, "labels": labels})

    def span(self, name: str, **labels) -> Span:
        return Span(self, name, labels)

    # --------------------------------------------------------------- queries

    def _memory(self):
        from repro_torch.telemetry.sinks import MemorySink

        for s in self.sinks:
            if isinstance(s, MemorySink):
                return s
        raise LookupError(
            "recorder has no MemorySink — series queries need one "
            "(Recorder(sinks=[MemorySink(), ...]))"
        )

    def values(self, name: str, **labels) -> List[float]:
        """All recorded values of a gauge/hist/counter series, in order
        (requires a MemorySink)."""
        return self._memory().values(name, **labels)

    def spans(self, name: Optional[str] = None, **labels) -> List[Dict]:
        """All completed span events (requires a MemorySink)."""
        return self._memory().spans(name, **labels)

    def total(self, name: str, **labels) -> float:
        """Running total of a counter series (0 if never incremented)."""
        return self._totals.get(_series_key(name, labels), 0)

    # ------------------------------------------------------------- lifecycle

    def flush(self) -> None:
        for s in self.sinks:
            flush = getattr(s, "flush", None)
            if flush is not None:
                flush()

    def close(self) -> None:
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()


class NullRecorder:
    """The off path: same surface as `Recorder`, every method a no-op.
    ``telemetry.get()`` returns the singleton `NULL` unless a recorder was
    configured, so uninstrumented behavior is preserved exactly."""

    enabled = False
    sinks: List = []
    meta: Dict = {}

    def counter(self, name: str, value: float = 1, **labels) -> float:
        return 0

    def gauge(self, name: str, value: float, **labels) -> None:
        return None

    def hist(self, name: str, value: float, **labels) -> None:
        return None

    def span(self, name: str, **labels) -> _NullSpan:
        return _NULL_SPAN

    def total(self, name: str, **labels) -> float:
        return 0

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


NULL = NullRecorder()
