"""`repro_torch.telemetry` — the tracing/metrics spine (the port's copy of
`repro.telemetry`; pure Python, no device work).

`Recorder` keeps counters, gauges and histograms over labelled series and
times `span()` regions on a monotonic clock; sinks take its events (a JSONL
stream, an in-memory ring) and `chrome_trace` turns them into a
Perfetto/``chrome://tracing`` document. Instrumented code calls
``telemetry.get()``: the active recorder, or the no-op `NULL` recorder when
telemetry is off, so the off path does no work beyond that lookup.

Wiring (the training launcher's ``--telemetry out.jsonl``)::

    from repro_torch import telemetry
    rec = telemetry.configure(jsonl="run.jsonl")   # active process-wide
    ... run ...
    telemetry.shutdown()                           # flush + deactivate

Scoped activation for tests::

    rec = Recorder(sinks=[MemorySink()])
    with telemetry.recording(rec):
        ...                           # instrumented code records into rec
    rec.spans("session.step")
"""
from __future__ import annotations

import atexit
from contextlib import contextmanager
from typing import Optional

from repro_torch.telemetry.export import (
    chrome_trace, load_jsonl, summarize_hist, write_chrome_trace,
)
from repro_torch.telemetry.recorder import (
    EVENT_KEYS, EVENT_KINDS, NULL, NullRecorder, Recorder, Span,
)
from repro_torch.telemetry.sinks import JsonlSink, MemorySink

__all__ = [
    "Recorder", "NullRecorder", "Span", "NULL", "EVENT_KEYS", "EVENT_KINDS",
    "JsonlSink", "MemorySink",
    "chrome_trace", "write_chrome_trace", "load_jsonl", "summarize_hist",
    "get", "set_active", "configure", "recording", "shutdown",
]

_active = NULL
_atexit_registered = False


def get():
    """The active recorder (`NULL` when telemetry is off). Instrumentation
    sites call this per use — activation is dynamic, never cached."""
    return _active


def set_active(rec) -> None:
    """Install ``rec`` as the process-wide active recorder (None → off)."""
    global _active
    _active = NULL if rec is None else rec


def configure(*, jsonl: Optional[str] = None, memory: bool = False,
              memory_maxlen: Optional[int] = 65536, clock=None) -> Recorder:
    """Build a `Recorder` with the requested sinks, make it active, and
    flush it at interpreter exit. ``jsonl`` adds a `JsonlSink` at that path;
    ``memory=True`` adds a `MemorySink` ring (for in-process queries)."""
    global _atexit_registered
    sinks = []
    if jsonl is not None:
        sinks.append(JsonlSink(jsonl))
    if memory:
        sinks.append(MemorySink(maxlen=memory_maxlen))
    kw = {} if clock is None else {"clock": clock}
    rec = Recorder(sinks=sinks, **kw)
    set_active(rec)
    if not _atexit_registered:
        atexit.register(shutdown)
        _atexit_registered = True
    return rec


def shutdown() -> None:
    """Flush + close the active recorder's sinks and deactivate it."""
    global _active
    rec, _active = _active, NULL
    rec.close()


@contextmanager
def recording(rec):
    """Scoped activation: ``rec`` is active inside the block, the previous
    recorder is restored on exit (exception-safe)."""
    global _active
    prev = _active
    _active = NULL if rec is None else rec
    try:
        yield rec
    finally:
        _active = prev
