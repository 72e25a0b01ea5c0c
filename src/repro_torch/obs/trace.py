"""Structured tracing: spans, events, JSONL and Chrome-trace exporters.

A :class:`Tracer` records two record kinds into one in-memory list:

* **spans** — named intervals (``parse``/``stats``/``cost``/``compile``/
  ``dispatch``/``transfer``/...) with microsecond start/duration relative
  to the tracer's epoch, a unique ``id`` and the enclosing span's
  ``parent`` id (spans are recorded on EXIT, so children precede their
  parent in the record stream but nest inside it in time);
* **events** — named instants (per-traversal-level progress, overflow
  retries) attributed to the enclosing span.

Per-level traversal events are derived HOST-SIDE from an executed
:class:`~repro_torch.core.operators.BFSResult` (:func:`emit_level_events`),
as in the reference, whose fixed-point loop runs on the device:
``row_depths`` (BFS level per result row) is histogrammed into per-level
edge counts and ``level_dirs`` decodes each level's taken push/pull
direction.  This keeps the traced numbers exactly the executed result's
numbers, and keeps the hot loop untouched.

The module-global ``current_tracer()`` seam is how the engine and serving
layers find the active tracer: installing one (``set_tracer``) turns
tracing on everywhere downstream; the disabled path is a module attribute
read plus a ``None`` check.

Schema (JSON-lines, one record per line; see docs/observability.md):

.. code-block:: text

    {"type": "header", "schema_version": 1, "clock": "...", "meta": {...}}
    {"type": "span",  "id": 3, "parent": 1, "name": "dispatch",
     "ts_us": 12.5, "dur_us": 480.2, "attrs": {...}}
    {"type": "event", "name": "level", "parent": 3, "ts_us": 200.1,
     "attrs": {"level": 2, "dir": "pull", "edges": 4096, ...}}

The Chrome-trace export (:meth:`Tracer.chrome_trace`) maps spans onto
complete (``"ph": "X"``) events and events onto thread-scoped instants —
load the written file directly in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Iterator, Optional

__all__ = ["TRACE_SCHEMA_VERSION", "Tracer", "current_tracer", "set_tracer",
           "trace_span", "trace_event", "emit_level_events", "read_jsonl"]

TRACE_SCHEMA_VERSION = 1

_CLOCK = "perf_counter, microseconds since tracer epoch"


class Tracer:
    """Span/event recorder.  ``enabled=False`` makes every call a cheap
    no-op (kept for symmetry with a config flag; an uninstalled tracer is
    cheaper still).  ``level_events=False`` suppresses the per-level
    traversal events (which require a device->host read of ``row_depths``)
    while keeping the spans."""

    def __init__(self, *, enabled: bool = True, level_events: bool = True,
                 meta: Optional[dict] = None):
        self.enabled = enabled
        self.level_events = level_events
        self.meta = dict(meta or {})
        self.records: list[dict] = []
        self._stack: list[int] = []
        self._next_id = 0
        self._epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record a named interval.  Yields the (mutable) attrs dict so the
        body can attach results discovered mid-span."""
        if not self.enabled:
            yield attrs
            return
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        self._stack.append(sid)
        t0 = self._now_us()
        try:
            yield attrs
        finally:
            self._stack.pop()
            self.records.append({
                "type": "span", "id": sid, "parent": parent, "name": name,
                "ts_us": t0, "dur_us": self._now_us() - t0, "attrs": attrs})

    def event(self, name: str, **attrs) -> None:
        """Record a named instant inside the current span (if any)."""
        if not self.enabled:
            return
        self.records.append({
            "type": "event", "name": name,
            "parent": self._stack[-1] if self._stack else None,
            "ts_us": self._now_us(), "attrs": attrs})

    # -- exporters ---------------------------------------------------------
    def _header(self) -> dict:
        return {"type": "header", "schema_version": TRACE_SCHEMA_VERSION,
                "clock": _CLOCK, "meta": self.meta}

    def iter_records(self) -> Iterator[dict]:
        yield self._header()
        yield from self.records

    def write_jsonl(self, path: str) -> str:
        """One JSON record per line, header first."""
        with open(path, "w") as f:
            for rec in self.iter_records():
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON (Perfetto-loadable): spans as
        complete ``"X"`` slices, events as thread-scoped instants."""
        evs = []
        for rec in self.records:
            if rec["type"] == "span":
                evs.append({"name": rec["name"], "ph": "X",
                            "ts": rec["ts_us"], "dur": rec["dur_us"],
                            "pid": 0, "tid": 0, "args": rec["attrs"]})
            else:
                evs.append({"name": rec["name"], "ph": "i", "s": "t",
                            "ts": rec["ts_us"], "pid": 0, "tid": 0,
                            "args": rec["attrs"]})
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"schema_version": TRACE_SCHEMA_VERSION,
                              **self.meta}}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def read_jsonl(path: str) -> list[dict]:
    """Read a JSONL trace back (header first) — the roundtrip inverse of
    :meth:`Tracer.write_jsonl`.  Raises ``ValueError`` on a missing or
    version-incompatible header."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records or records[0].get("type") != "header":
        raise ValueError(f"{path}: not a trace (no header record)")
    v = records[0].get("schema_version")
    if v != TRACE_SCHEMA_VERSION:
        raise ValueError(f"{path}: unsupported trace schema_version {v!r} "
                         f"(this reader handles {TRACE_SCHEMA_VERSION})")
    return records


# ---------------------------------------------------------------------------
# the module-global seam (what the engine / serving layers consult)
# ---------------------------------------------------------------------------

_CURRENT: Optional[Tracer] = None
_NOOP = contextlib.nullcontext({})     # reentrant: one shared instance


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-global tracer; returns the
    previous one (restore it when done)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer
    return prev


def current_tracer() -> Optional[Tracer]:
    t = _CURRENT
    return t if (t is not None and t.enabled) else None


def trace_span(name: str, **attrs):
    """Span on the current tracer, or a shared no-op context manager —
    this is the only cost a hot path pays when tracing is off."""
    t = _CURRENT
    if t is None or not t.enabled:
        return _NOOP
    return t.span(name, **attrs)


def trace_event(name: str, **attrs) -> None:
    t = _CURRENT
    if t is not None and t.enabled:
        t.event(name, **attrs)


# ---------------------------------------------------------------------------
# per-level traversal events, derived from an executed BFSResult
# ---------------------------------------------------------------------------

def _dir_name(code: int) -> Optional[str]:
    return {0: "push", 1: "pull"}.get(int(code))


def emit_level_events(tracer: Tracer, result, *, bytes_per_row: float = 0.0,
                      **attrs) -> None:
    """Emit one ``level`` event per executed BFS level of ``result`` (a
    single-root or batched ``BFSResult``), derived host-side:

    * ``edges`` — result rows whose ``row_depths`` equal the level (the
      edges emitted while that level's frontier expanded), summed over
      lanes for a batched result;
    * ``frontier`` — the rows that ENTERED the level (the previous level's
      emitted edges; 1 root row at level 0);
    * ``dir`` — the taken push/pull direction decoded from ``level_dirs``
      (``None`` for push-only engines; ``"mixed"`` when a batched
      dispatch's lanes disagree);
    * ``bytes_est`` — ``edges * bytes_per_row`` when a per-row byte width
      is supplied (e.g. the plan's ``total_bytes / result_rows``).

    Forcing ``row_depths`` to host synchronizes the dispatch — level
    events are an enabled-tracing cost only.  Tensors on the card are
    copied to the host first (numpy cannot read them in place)."""
    if tracer is None or not tracer.enabled or not tracer.level_events:
        return
    if getattr(result, "row_depths", None) is None:
        return
    import numpy as np

    def host(a):
        return np.asarray(a.cpu() if hasattr(a, "cpu") else a)

    rd = host(result.row_depths)
    count = host(result.count).reshape(-1)
    depth = int(np.max(host(result.depth)))
    if rd.ndim == 1:
        rd = rd[None, :]
    # per-lane valid-row masks -> pooled per-level edge counts
    lanes = np.arange(rd.shape[1])[None, :] < count[:, None]
    valid = rd[lanes]
    valid = valid[valid >= 0]
    edges = np.bincount(valid.astype(np.int64), minlength=depth or 1)

    dirs = getattr(result, "level_dirs", None)
    taken = None
    if dirs is not None:
        dv = host(dirs)
        if dv.size:
            taken = dv if dv.ndim == 2 else dv[None, :]
    n_lanes = int(count.shape[0])
    for lvl in range(depth):
        d = None
        if taken is not None and lvl < taken.shape[1]:
            codes = {int(c) for c in taken[:, lvl] if int(c) >= 0}
            if len(codes) == 1:
                d = _dir_name(codes.pop())
            elif codes:
                d = "mixed"
        n = int(edges[lvl]) if lvl < edges.shape[0] else 0
        frontier = n_lanes if lvl == 0 else (
            int(edges[lvl - 1]) if lvl - 1 < edges.shape[0] else 0)
        ev = {"level": lvl, "dir": d, "edges": n, "frontier": frontier}
        if bytes_per_row:
            ev["bytes_est"] = n * float(bytes_per_row)
        tracer.event("level", **ev, **attrs)
