"""Trace checker: validate the records of a JSONL trace written by
:mod:`repro_torch.obs.trace` (the rules of the repo's
``scripts/check_trace.py``, kept as the port's own copy).

Checks (each violation is reported with a reason):

* every record after the header is a ``span`` or ``event`` with its
  required fields (spans: ``id``/``parent``/``name``/``ts_us``/``dur_us``/
  ``attrs``; events: ``name``/``parent``/``ts_us``/``attrs``) and sane
  types;
* span ids are unique, parents reference REAL span ids, and no span is its
  own ancestor (the parent graph is a forest);
* every child span nests in TIME inside its parent (child interval within
  the parent interval, small float slack) — spans are recorded on exit, so
  stream order is children-first; the time containment is the invariant;
* at least ``min_spans`` spans — a trivially empty trace means the tracer
  was not actually installed.

The header itself (first record, supported ``schema_version``) is
validated by :func:`repro_torch.obs.trace.read_jsonl`.  One difference
from the script: a span without a numeric ``ts_us`` or ``dur_us`` is
reported as a bad field and left out of the nesting check, where the
script stops with a ``KeyError``.

Usage: ``python -m repro_torch.obs.check_trace TRACE.jsonl
[--min-spans N]``.
"""
from __future__ import annotations

import sys

SLACK_US = 5.0          # float/clock slack for the nesting containment


def _interval(rec: dict):
    """A span's ``(start, end)`` in microseconds, None without numeric
    ``ts_us`` and ``dur_us``."""
    ts, dur = rec.get("ts_us"), rec.get("dur_us")
    if isinstance(ts, (int, float)) and isinstance(dur, (int, float)):
        return ts, ts + dur
    return None


def check_trace(records: list[dict], min_spans: int = 1) -> list[str]:
    """All violations found in an already-parsed record list (header
    first).  Empty list == valid."""
    errors = []
    spans = {}
    for i, rec in enumerate(records[1:], start=1):
        t = rec.get("type")
        if t == "span":
            for field, typ in (("id", int), ("name", str),
                               ("ts_us", (int, float)),
                               ("dur_us", (int, float)), ("attrs", dict)):
                if not isinstance(rec.get(field), typ):
                    errors.append(f"record {i}: span missing/bad {field!r}")
            if "parent" not in rec:
                errors.append(f"record {i}: span missing 'parent'")
            sid = rec.get("id")
            if sid in spans:
                errors.append(f"record {i}: duplicate span id {sid}")
            elif isinstance(sid, int):
                spans[sid] = rec
        elif t == "event":
            for field, typ in (("name", str), ("ts_us", (int, float)),
                               ("attrs", dict)):
                if not isinstance(rec.get(field), typ):
                    errors.append(f"record {i}: event missing/bad {field!r}")
            if "parent" not in rec:
                errors.append(f"record {i}: event missing 'parent'")
        else:
            errors.append(f"record {i}: unknown record type {t!r}")

    for sid, rec in spans.items():
        parent = rec.get("parent")
        if parent is None:
            continue
        if parent not in spans:
            errors.append(f"span {sid} ({rec.get('name')}): parent {parent} "
                          "is not a recorded span")
            continue
        # no self-ancestry (forest check walks to a root or repeats)
        seen, p = {sid}, parent
        while p is not None:
            if p in seen:
                errors.append(f"span {sid}: ancestry cycle via {p}")
                break
            seen.add(p)
            p = spans[p].get("parent") if p in spans else None
        # time containment (a span without a numeric interval was
        # reported above, and is not measured against its parent)
        par = spans[parent]
        child, outer = _interval(rec), _interval(par)
        if child is None or outer is None:
            continue
        if child[0] < outer[0] - SLACK_US or child[1] > outer[1] + SLACK_US:
            errors.append(
                f"span {sid} ({rec.get('name')}) "
                f"[{child[0]:.1f}, {child[1]:.1f}] "
                f"does not nest in parent {parent} ({par.get('name')}) "
                f"[{outer[0]:.1f}, {outer[1]:.1f}]")

    if len(spans) < min_spans:
        errors.append(f"only {len(spans)} span(s), expected >= {min_spans} "
                      "(tracer not installed?)")
    return errors


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    min_spans = 1
    if "--min-spans" in argv:
        i = argv.index("--min-spans")
        min_spans = int(argv[i + 1])
        del argv[i:i + 2]
    if not argv:
        print("usage: python -m repro_torch.obs.check_trace TRACE.jsonl "
              "[--min-spans N]")
        return 2
    path = argv[0]

    from .trace import read_jsonl
    try:
        records = read_jsonl(path)       # validates header + version
    except (OSError, ValueError) as e:
        print(f"TRACE CHECK FAILED: {e}")
        return 1
    errors = check_trace(records, min_spans=min_spans)
    if errors:
        print(f"TRACE CHECK FAILED ({path}):")
        for msg in errors:
            print(f"  FAIL {msg}")
        return 1
    n_spans = sum(1 for r in records if r.get("type") == "span")
    n_events = sum(1 for r in records if r.get("type") == "event")
    print(f"trace OK: {n_spans} span(s), {n_events} event(s), "
          f"schema {records[0]['schema_version']} in {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
