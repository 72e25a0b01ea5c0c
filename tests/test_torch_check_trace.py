"""The port's trace checker (``repro_torch.obs.check_trace``) against the
repo's ``scripts/check_trace.py``, loaded by file path: the same list of
violations, message for message, on a valid trace the port's tracer
wrote and on broken copies of it (a missing field, a parent that does not
exist, a child outside its parent, a duplicate id, an unknown record type,
an ancestry cycle, too few spans).  A span without its interval stops
the script with a ``KeyError``; the port reports it as a bad field.
"""
import copy
import importlib.util
import json
import os

import pytest

from repro_torch.obs import Tracer, read_jsonl
from repro_torch.obs import check_trace as port_check

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "check_trace.py")


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("check_trace_script",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A request-shaped trace from the port's tracer, through its JSONL
    writer and reader."""
    tr = Tracer(meta={"run": "check_trace"})
    with tr.span("request", requests=1):
        with tr.span("parse"):
            pass
        with tr.span("plan"):
            tr.event("admission", root=3, decision="degrade")
        with tr.span("dispatch", bucket=0, lanes=2):
            tr.event("level", level=0, edges=4)
        with tr.span("transfer", bucket=0):
            pass
    path = str(tmp_path_factory.mktemp("trace") / "t.jsonl")
    tr.write_jsonl(path)
    return read_jsonl(path)


def spans(recs):
    return [r for r in recs if r.get("type") == "span"]


def broken(records, case):
    recs = copy.deepcopy(records)
    first, last = spans(recs)[0], spans(recs)[-1]       # parse, request
    if case == "missing field":
        del first["name"]
    elif case == "missing parent key":
        del first["parent"]
    elif case == "bad event":
        ev = next(r for r in recs if r.get("type") == "event")
        ev["attrs"] = "x"
    elif case == "unknown parent":
        first["parent"] = 999
    elif case == "outside its parent":
        first["ts_us"] = last["ts_us"] + last["dur_us"] + 100.0
    elif case == "duplicate id":
        recs.append(dict(first))
    elif case == "unknown type":
        recs.append({"type": "blob"})
    elif case == "cycle":
        last["parent"] = first["id"]
    return recs


CASES = ("valid", "missing field", "missing parent key", "bad event",
         "unknown parent", "outside its parent", "duplicate id",
         "unknown type", "cycle")


@pytest.mark.parametrize("case", CASES)
def test_same_violations_as_the_script(script, records, case):
    recs = records if case == "valid" else broken(records, case)
    got = port_check.check_trace(recs, min_spans=5)
    assert got == script.check_trace(recs, min_spans=5)
    assert (got == []) == (case == "valid")


@pytest.mark.parametrize("min_spans", [1, 5, 6, 50])
def test_too_few_spans(script, records, min_spans):
    got = port_check.check_trace(records, min_spans=min_spans)
    assert got == script.check_trace(records, min_spans=min_spans)
    assert (got == []) == (min_spans <= len(spans(records)))
    assert port_check.check_trace(records[:1], min_spans=1) == \
        script.check_trace(records[:1], min_spans=1)


def test_cli(records, tmp_path, capsys):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    assert port_check.main([path, "--min-spans", "5"]) == 0
    assert "trace OK: 5 span(s), 2 event(s)" in capsys.readouterr().out
    assert port_check.main([path, "--min-spans", "6"]) == 1
    assert port_check.main([]) == 2
    with open(path, "w") as f:
        f.write("{}\n")
    assert port_check.main([path]) == 1


@pytest.mark.parametrize("field", ["ts_us", "dur_us"])
def test_span_without_interval_is_reported(script, records, field):
    """Where the script raises, the port names the field and checks the
    rest."""
    recs = copy.deepcopy(records)
    del spans(recs)[0][field]
    with pytest.raises(KeyError):
        script.check_trace(recs, min_spans=5)
    assert port_check.check_trace(recs, min_spans=5) == \
        [f"record 1: span missing/bad {field!r}"]
