"""Sinks: where recorder events land (the port's copy of
`repro/telemetry/sinks.py`).

A sink is anything with ``write(event: dict)`` (optionally ``flush`` /
``close``). Two ship here:

* `JsonlSink` — one JSON object per line, append-ordered, compact
  separators; the durable stream the launchers' ``--telemetry`` writes.
* `MemorySink` — a bounded in-memory ring (``collections.deque``) with
  query helpers; the sink tests and `chip_smoke.py` read.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, List, Optional


class JsonlSink:
    """Writes every event as one compact JSON line. ``path`` is opened
    lazily on the first write (so configuring telemetry never creates empty
    files); pass a file-like object instead to control the stream."""

    def __init__(self, path_or_file, *, flush_every: int = 64):
        if hasattr(path_or_file, "write"):
            self._f, self._path, self._own = path_or_file, None, False
        else:
            self._f, self._path, self._own = None, path_or_file, True
        self._flush_every = max(1, flush_every)
        self._pending = 0
        self.written = 0

    def write(self, event: Dict) -> None:
        if self._f is None:
            self._f = open(self._path, "w")
        self._f.write(json.dumps(event, separators=(",", ":")) + "\n")
        self.written += 1
        self._pending += 1
        if self._pending >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
        self._pending = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            if self._own:
                self._f.close()
                self._f = None


class MemorySink:
    """Bounded in-memory ring of events, oldest-dropped, with the query
    helpers the tests and benchmarks hang off."""

    def __init__(self, maxlen: Optional[int] = 65536):
        self._ring: deque = deque(maxlen=maxlen)

    def write(self, event: Dict) -> None:
        self._ring.append(event)

    def __len__(self) -> int:
        return len(self._ring)

    # --------------------------------------------------------------- queries

    @staticmethod
    def _match(ev: Dict, kind, name, labels) -> bool:
        if kind is not None and ev["kind"] != kind:
            return False
        if name is not None and ev["name"] != name:
            return False
        evl = ev.get("labels", {})
        return all(evl.get(k) == v for k, v in labels.items())

    def events(self, kind: Optional[str] = None, name: Optional[str] = None,
               **labels) -> List[Dict]:
        return [e for e in self._ring if self._match(e, kind, name, labels)]

    def values(self, name: str, **labels) -> List[float]:
        """Recorded values of a gauge/hist/counter series, in order."""
        return [e["value"] for e in self._ring
                if e["kind"] != "span" and self._match(e, None, name, labels)]

    def spans(self, name: Optional[str] = None, **labels) -> List[Dict]:
        return self.events(kind="span", name=name, **labels)

    def durations(self, name: str, **labels) -> List[float]:
        """Span durations (seconds) of one span series, in completion
        order."""
        return [e["dur"] for e in self.spans(name, **labels)]

    def clear(self) -> None:
        self._ring.clear()
