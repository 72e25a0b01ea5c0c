"""The port's EXPLAIN and EXPLAIN ANALYZE (``repro_torch.planner.explain``)
against the live JAX reference's, on the CPU.

Inputs are made from numpy seeds and carried into both packages.
Tolerances: the ``explain`` text is equal character for character;
``explain_json`` documents are equal key for key, every integer, string
and bool exactly and every float exactly or within a relative 1e-12 (the
planner's prices, ``est_us`` and the byte sums, are float64 sums whose
order of adds may differ in the last bit); ``explain_analyze`` documents
likewise, except the ``elapsed_us``
wall time, which is left out by name.  ``render_analyze`` is compared on
documents whose ``elapsed_us`` was set to the same number.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import (DIROPT_ENGINE_NAMES, ENGINE_NAMES,
                               EngineCaps as RefCaps)
from repro import planner as ref
from repro.planner.ast import weighted_listing
from repro_torch import planner as port
from repro_torch.core import engine as port_engine
from repro_torch.data.treegen import TreeSpec, make_edge_table
from test_torch_engine import both_datasets
from test_torch_engine import release_reference_executables  # noqa: F401

RTOL = 1e-12
CAPS = (2048, 4096)
TREE = TreeSpec(num_vertices=3000, height=10, payload_cols=4, seed=11)
TIMING_KEYS = ("elapsed_us",)


def caps(mod):
    return RefCaps(*CAPS) if mod is ref else port_engine.EngineCaps(*CAPS)


def assert_doc_equal(got, want, path="doc", skip=TIMING_KEYS):
    """Two JSON-shaped documents equal: the same keys (those named in
    ``skip`` left out), lists of the same length, integers, strings,
    bools and None exactly, floats exactly or within ``RTOL``."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        gk = {k for k in got if k not in skip}
        wk = {k for k in want if k not in skip}
        assert gk == wk, (path, sorted(gk ^ wk))
        for k in wk:
            assert_doc_equal(got[k], want[k], f"{path}.{k}", skip)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_doc_equal(g, w, f"{path}[{i}]", skip)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (float, int)) and not isinstance(got, bool), \
            path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), \
                (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def edge_columns(src, dst, payload_cols=0):
    e = len(src)
    cols = {"id": np.arange(e, dtype=np.int32),
            "from": np.asarray(src, np.int32),
            "to": np.asarray(dst, np.int32),
            "name": np.zeros((e, 4), np.float32)}
    for i in range(payload_cols):
        cols[f"column{i + 1}"] = np.full((e,), float(i), np.float32)
    return cols


def star(spokes):
    """Vertex 0 -> 1..spokes (tests/test_obs.py's star): the only source
    vertex is the sampled root, so predicted equals actual to the row."""
    return both_datasets(edge_columns(np.zeros(spokes, np.int32),
                                      np.arange(1, spokes + 1)), spokes + 1)


@pytest.fixture(scope="module")
def tree():
    """The golden tree of tests/test_obs.py with a seeded float32 weight
    column ``w``, in both packages."""
    cols = make_edge_table(TREE)
    cols["w"] = np.random.default_rng(11).uniform(
        0.5, 2.0, TREE.num_edges).astype(np.float32)
    return both_datasets(cols, TREE.num_vertices)


def directed(sql, direction):
    if direction == "inbound":
        return (sql.replace('WHERE "from" =', 'WHERE "to" =')
                .replace('e."from" = t."to"', 'e."to" = t."from"'))
    if direction == "both":
        return sql.replace('e."from" = t."to"',
                           'e."from" = t."to" OR e."to" = t."from"')
    return sql


QUERIES = {
    "p1": ref.paper_listing(1, root=0, depth=7),
    "p2": ref.paper_listing(2, root=0, depth=7, payload_cols=4),
    "p3": ref.paper_listing(3, root=0, depth=7),
    "p1-inbound": directed(ref.paper_listing(1, root=5, depth=6), "inbound"),
    "p1-both": directed(ref.paper_listing(1, root=5, depth=6), "both"),
    "sssp": weighted_listing("shortest_path", root=0, depth=6,
                             weight_col="w"),
    "sum": weighted_listing("aggregate_sum", root=0, depth=6,
                            weight_col="w"),
}


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_text_and_json_equal(tree, name, kernel):
    """The rendered report is the reference's, character for character,
    and the machine-readable plan its document (the kernel candidate
    priced under one pinned factor in both packages)."""
    ref_ds, port_ds = tree
    sql = QUERIES[name]
    kw = {"include_kernel": kernel}
    if kernel:
        ref.calibrate.set_measured_kernel_factor(2.5)
        port.calibrate.set_measured_kernel_factor(2.5, backend="cpu")
    try:
        want_text = ref.explain(sql, ref_ds, caps=caps(ref), **kw)
        got_text = port.explain(sql, port_ds, caps=caps(port), **kw)
        want = ref.explain_json(sql, ref_ds, caps=caps(ref), **kw)
        got = port.explain_json(sql, port_ds, caps=caps(port), **kw)
    finally:
        if kernel:
            ref.calibrate.set_measured_kernel_factor(None)
            port.calibrate.set_measured_kernel_factor(None, backend="cpu")
    assert got_text == want_text
    assert_doc_equal(got, want, skip=())
    assert got["schema_version"] == 6 and got["analyze"] is None


def test_explain_without_caps_and_engine_reexports(tree):
    """Statistics-derived caps, and the ``Dataset``-level re-exports in
    ``repro_torch.core.engine``."""
    ref_ds, port_ds = tree
    sql = QUERIES["p2"]
    assert port_engine.explain(sql, port_ds) == ref.explain(sql, ref_ds)
    got = port_engine.explain_analyze(sql, port_ds)
    want = ref.explain_analyze(sql, ref_ds)
    assert_doc_equal(got, want)


def test_to_json_with_buckets(tree):
    ref_ds, port_ds = tree
    sql = QUERIES["p1"]
    roots = [0, 1, 17, 2999]
    docs = []
    for mod, ds in ((ref, ref_ds), (port, port_ds)):
        report = mod.plan(sql, ds, caps=caps(mod))
        b = report.best.query
        buckets = mod.bucket_roots(ds, roots, direction=b.direction,
                                   max_depth=b.max_depth, dedup=b.dedup,
                                   caps=b.caps)
        docs.append(mod.to_json(report, buckets=buckets))
    assert_doc_equal(docs[1], docs[0], skip=())
    assert docs[1]["buckets"]


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

def analyze_both(sql, ref_ds, port_ds, **kw):
    want = ref.explain_analyze(sql, ref_ds, caps=caps(ref), **kw)
    got = port.explain_analyze(sql, port_ds, caps=caps(port), **kw)
    assert_doc_equal(got, want)
    assert got["analyze"]["elapsed_us"] > 0
    return got, want


@pytest.mark.parametrize("engine", ENGINE_NAMES)
def test_explain_analyze_star_every_engine(engine):
    """tests/test_obs.py's star, every engine: the whole document but the
    wall time, and predicted equal to actual as the reference has it."""
    ref_ds, port_ds = star(48)
    got, _ = analyze_both(ref.paper_listing(1, root=0, depth=3), ref_ds,
                          port_ds, engine=engine)
    a = got["analyze"]
    assert a["engine"] == engine and a["result_count"] == 48
    assert a["actual"]["rows"] == a["result_count"]


@pytest.mark.parametrize("seed", [0, 3, 17, 255])
def test_explain_analyze_star_seeded(seed):
    spokes = int(np.random.RandomState(seed).randint(4, 200))
    ref_ds, port_ds = star(spokes)
    got, _ = analyze_both(ref.paper_listing(1, root=0, depth=2), ref_ds,
                          port_ds)
    assert got["analyze"]["result_count"] == spokes


@pytest.mark.parametrize("engine", DIROPT_ENGINE_NAMES)
def test_explain_analyze_direction_reconciliation(tree, engine):
    """The direction-optimizing engines on the tree: predicted and TAKEN
    per-level push/pull equal to the reference's."""
    ref_ds, port_ds = tree
    got, _ = analyze_both(ref.paper_listing(1, root=0, depth=6), ref_ds,
                          port_ds, engine=engine)
    taken = [lv["dir_taken"] for lv in got["analyze"]["levels"]]
    assert "pull" in taken or "push" in taken


@pytest.mark.parametrize("name", ["p1", "p2", "p3", "p1-inbound", "sum"])
def test_explain_analyze_listings(tree, name):
    """The chosen plan of each listing, executed: the analyze section equal
    to the reference's, and the row table never built for it (the row
    width is priced from the layout)."""
    ref_ds, port_ds = tree
    got, want = analyze_both(QUERIES[name], ref_ds, port_ds)
    assert got["analyze"]["engine"] == want["analyze"]["engine"]
    if not got["analyze"]["engine"].startswith("rowstore"):
        assert port_ds.rows is None


def test_render_analyze_equal(tree):
    ref_ds, port_ds = tree
    for engine in ("diropt", "precursive"):
        got, want = analyze_both(QUERIES["p1"], ref_ds, port_ds,
                                 engine=engine)
        got["analyze"]["elapsed_us"] = want["analyze"]["elapsed_us"]
        assert port.render_analyze(got) == ref.render_analyze(want)
    with pytest.raises(ValueError, match="no analyze section"):
        port.render_analyze(port.explain_json(QUERIES["p1"], port_ds))


def test_analyze_result_of_a_given_result(tree):
    """``analyze_result`` on a result the caller ran (no wall time): equal
    to the reference's, ``elapsed_us`` None in both."""
    ref_ds, port_ds = tree
    sql = QUERIES["p3"]
    docs = []
    for mod, ds in ((ref, ref_ds), (port, port_ds)):
        report = mod.plan(sql, ds, caps=caps(mod))
        r = report.best.run(ds, 7)
        docs.append(mod.analyze_result(report.best, report, ds, r, root=7))
    assert_doc_equal(docs[1], docs[0], skip=())
    assert docs[1]["elapsed_us"] is None


def test_explain_analyze_errors_match(tree):
    ref_ds, port_ds = tree
    inbound = QUERIES["p1-inbound"]
    for sql, kw, match in (
            (inbound, {"engine": "rowstore"}, "was skipped"),
            (QUERIES["p1"], {"engine": "nope"}, "unknown engine"),
            (ref.paper_listing(1, depth=3).replace(
                'WHERE "from" = 0', 'WHERE "from" = :root'), {},
             "literal root")):
        with pytest.raises(ValueError, match=match) as want:
            ref.explain_analyze(sql, ref_ds, **kw)
        with pytest.raises(ValueError, match=match) as got:
            port.explain_analyze(sql, port_ds, **kw)
        assert str(got.value) == str(want.value)
