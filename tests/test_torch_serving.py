"""The port's traversal serving layer (``repro_torch.planner.serving``)
against the live JAX reference's, on the CPU.

One request sequence runs through a reference ``ServingSession`` and a port
``ServingSession`` over the same seeded tree (built once per module: the
reference compiles once per bucket signature), and every step is compared:
each lane bit for bit on every field (tolerance 0: serving does no float
arithmetic on the reach path, and the weighted lanes combine one arrival a
vertex on a tree), the ``RequestReport``, the ``stats`` apart from the
latency keys (``last_latency_us``, ``latency_us_p50/p95/p99``) and the
report but its ``straggler_buckets`` (a wall time against an EMA), the
``plan_json`` (floats within a relative 1e-12, as in
``tests/test_torch_explain.py``) and the per-bucket engine labels.  The
cases are those of tests/test_serving.py (plan caching, rebinding,
permuted roots, per-bucket choices, the plan document) and
tests/test_obs.py (overflow surfacing, stats keys, the metrics registry,
traced requests, serving EXPLAIN ANALYZE), plus coalesced ``enqueue`` /
``flush``, the admission ladder and the front door's typed errors.  Trace
records are compared without their times (``ts_us``, ``dur_us`` and the
``elapsed_us`` / ``latency_us`` attributes).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs
from repro import planner as ref
from repro.core.engine import BucketTiming as RefTiming
from repro.core.engine import EngineCaps as RefCaps
from repro.planner.ast import weighted_listing
from repro_torch import planner as port
from repro_torch import obs as port_obs
from repro_torch.core import engine as port_engine
from repro_torch.data.treegen import TreeSpec, make_edge_table
from repro_torch.obs.check_trace import check_trace
from test_torch_engine import both_datasets
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_explain import assert_doc_equal

CAPS = (2048, 4096)
TREE = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
LATENCY_KEYS = ("last_latency_us", "latency_us_p50", "latency_us_p95",
                "latency_us_p99")
P1 = ref.paper_listing(1, root=0, depth=4)
P2 = ref.paper_listing(2, root=0, depth=5, payload_cols=2)
SUM = weighted_listing("aggregate_sum", root=0, depth=6, weight_col="w")
INBOUND = P1.replace('WHERE "from" =', 'WHERE "to" =').replace(
    'e."from" = t."to"', 'e."to" = t."from"')
# (step, call, sql, roots): the request sequence both sessions serve
SEQUENCE = (
    ("cold", "submit", P1, [0, 1, 2, 3]),
    ("repeat", "submit", P1, [0, 1, 2, 3]),
    ("pair", "submit", P1, [10, 11]),
    ("rebind", "submit", P1, [12, 13]),
    ("hub first", "submit", P1, [0, 1]),
    ("permuted", "submit", P1, [1, 0]),
    ("permuted again", "submit", P1, [1, 0]),
    ("plan only", "plan_json", P1, [0, 1, 2]),
    ("payloads", "submit", P2, [0, 1, 4, 2999]),
    ("inbound", "submit", INBOUND, [2999, 5, 0]),
    ("weighted", "submit", SUM, [0, 3, 77, 1500]),
    ("coalesced", "enqueue", P1, [0, 5, 17, 40, 5, 2999]),
    ("analyze", "explain_analyze", P1, [0, 1, 2, 7]),
)


def caps(mod):
    return RefCaps(*CAPS) if mod is ref else port_engine.EngineCaps(*CAPS)


@pytest.fixture(scope="module")
def tree():
    """tests/test_serving.py's tree with a seeded float32 weight column."""
    cols = make_edge_table(TREE)
    cols["w"] = np.random.default_rng(11).uniform(
        0.5, 2.0, TREE.num_edges).astype(np.float32)
    return both_datasets(cols, TREE.num_vertices)


def assert_same_lane(got, want, label=""):
    """One served lane of each package, every field bit for bit."""
    for field in ("positions", "count", "depth", "overflow", "row_depths",
                  "level_dirs", "vertex_values"):
        w = getattr(want, field)
        g = getattr(got, field)
        if w is None:
            assert g is None, (label, field)
            continue
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", \
            (label, field)
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (label, field)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {field}")
    assert sorted(got.values) == sorted(want.values), label
    for k, w in want.values.items():
        g, w = got.values[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (label, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


def report_doc(rep):
    """A RequestReport as plain data (guard decisions by ``to_json``),
    without ``straggler_buckets``: the straggler monitor flags a bucket by
    its wall time against the EMA of earlier ones, a clock reading."""
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
         if f.name != "straggler_buckets"}
    d["admission"] = (None if rep.admission is None
                      else [g.to_json() for g in rep.admission])
    d["degraded_roots"] = [list(x) for x in rep.degraded_roots]
    d["truncated"] = rep.truncated
    return d


def stats_doc(session):
    return {k: v for k, v in session.stats.items() if k not in LATENCY_KEYS}


def metrics_doc(session):
    """The metrics snapshot; a histogram by its observation count only."""
    return {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in session.metrics().items()}


def serve_step(session, call, sql, roots):
    if call == "submit":
        return session.submit(sql, roots)
    if call == "plan_json":
        return session.plan_json(sql, roots)
    if call == "explain_analyze":
        return session.explain_analyze(sql, roots)
    tickets = [session.enqueue(sql, r) for r in roots]
    assert all(not t.done for t in tickets)
    assert session.stats["pending_requests"] == len(roots)
    assert session.flush() == 1
    return [t.result() for t in tickets]


def run_sequence(session):
    snaps = []
    for step, call, sql, roots in SEQUENCE:
        out = serve_step(session, call, sql, roots)
        entry = session.plan_for(sql, roots)
        snaps.append({
            "step": step, "out": out,
            "report": report_doc(session.last_report),
            "stats": stats_doc(session),
            "plan_json": session.plan_json(sql, roots),
            "labels": [c.label for c in entry.bucket_choices],
            "buckets": [(b.indices, b.roots, tuple(b.caps))
                        for b in entry.buckets],
        })
    snaps.append({"metrics": metrics_doc(session),
                  "counters": dict(session.counters),
                  "cached": (len(session._logical), len(session._choice),
                             len(session._bucket_plans),
                             len(session._plans))})
    return snaps


@pytest.fixture(scope="module")
def sequence(tree):
    """Both sessions' snapshots of SEQUENCE, and the sessions."""
    ref_ds, port_ds = tree
    ref_s = ref.ServingSession(ref_ds, caps=caps(ref), calibrate_every=0)
    port_s = port.ServingSession(port_ds, caps=caps(port), calibrate_every=0)
    return run_sequence(ref_s), run_sequence(port_s), ref_s, port_s


STEPS = [s[0] for s in SEQUENCE]


@pytest.mark.parametrize("step", STEPS)
def test_sequence_step_matches_reference(sequence, step):
    """Each step: lanes (or the serving EXPLAIN ANALYZE document), the
    request report, the stats, the plan document, the bucket layout and
    each bucket's engine."""
    want_all, got_all, _, _ = sequence
    i = STEPS.index(step)
    want, got = want_all[i], got_all[i]
    call = SEQUENCE[i][1]
    if call in ("submit", "enqueue"):
        assert len(got["out"]) == len(want["out"])
        for k, (g, w) in enumerate(zip(got["out"], want["out"])):
            assert_same_lane(g, w, f"{step} lane {k}")
    else:
        assert_doc_equal(got["out"], want["out"])
    assert_doc_equal(got["report"], want["report"], skip=())
    assert got["stats"] == want["stats"]
    assert_doc_equal(got["plan_json"], want["plan_json"], skip=())
    assert got["labels"] == want["labels"]
    assert got["buckets"] == want["buckets"]


def test_sequence_totals_match_reference(sequence):
    """The metrics registry (histograms by count), the planning counters
    and the cache sizes after the whole sequence."""
    want, got = sequence[0][-1], sequence[1][-1]
    assert got == want
    assert got["metrics"]["repro_coalesced_dispatches_total"] == 1
    assert got["metrics"]["repro_coalesced_roots_total"] == 6


def test_serving_session_caches_plans(sequence):
    """tests/test_serving.py's cache cases on the port's own numbers: one
    miss then one hit, a rebind to the same signature, request order kept
    for permuted roots, and the per-bucket engines legal."""
    _, snaps, _, port_s = sequence
    by = {s["step"]: s for s in snaps[:-1]}
    # a snapshot's plan_for is one more lookup (a hit) before its stats,
    # its plan_json one after
    cold, repeat = by["cold"]["stats"], by["repeat"]["stats"]
    assert (cold["plan_misses"], cold["plan_hits"]) == (1, 1)
    assert (repeat["plan_misses"], repeat["plan_hits"]) == (1, 4)
    hub, perm = by["hub first"]["out"], by["permuted"]["out"]
    assert_same_lane(hub[0], perm[1]), assert_same_lane(hub[1], perm[0])
    entry = port_s.plan_for(P1, [0, 1, 2, 3])
    legal = {c.label for c in entry.report.ranked}
    for c, b in zip(entry.bucket_choices, entry.buckets):
        assert c.label in legal or (c.label == "multiquery"
                                    and c.query.lanes == len(b.roots) > 1)
    doc = by["plan only"]["plan_json"]
    # a plan never served carries no admission section; a served one does
    assert doc["schema_version"] == 6 and doc["admission"] is None
    assert by["cold"]["plan_json"]["admission"]["decisions"]
    assert sorted(l for b in doc["buckets"] for l in b["lanes"]) == [0, 1, 2]
    an = by["analyze"]["out"]["analyze"]
    assert an["mode"] == "serving"
    assert sorted(r for b in an["buckets"] for r in b["roots"]) == \
        [0, 1, 2, 7]


def traced_pair(tree, **kw):
    ref_ds, port_ds = tree
    out = []
    for mod, obs, ds in ((ref, ref_obs, ref_ds), (port, port_obs, port_ds)):
        tracer = obs.Tracer(meta={"run": "serving parity"})
        s = mod.ServingSession(ds, caps=caps(mod), calibrate_every=0,
                               tracer=tracer, **kw)
        lanes = [s.submit(P1, [0, 1]), s.submit(P1, [0, 1])]
        assert obs.current_tracer() is None     # restored after submit
        out.append((tracer, lanes))
    return out


def untimed(tracer):
    recs = []
    for rec in tracer.iter_records():
        rec = {k: v for k, v in rec.items() if k not in ("ts_us", "dur_us")}
        if "attrs" in rec:
            rec["attrs"] = {k: v for k, v in rec["attrs"].items()
                            if k not in ("elapsed_us", "latency_us")}
        recs.append(rec)
    return recs


def test_traced_requests_match_reference(tree):
    """A cold then a warm request, traced: the same records (header,
    spans, events, ids, parents, attributes) as the reference's without
    their times, valid under the port's trace checker, with the
    ``compile`` span on the cold serve only."""
    (tr, want), (tp, got) = traced_pair(tree)
    for g_req, w_req in zip(got, want):
        for g, w in zip(g_req, w_req):
            assert_same_lane(g, w, "traced")
    assert untimed(tp) == untimed(tr)
    assert check_trace(list(tp.iter_records()), min_spans=5) == []
    spans = [r for r in tp.records if r["type"] == "span"]
    names = [s["name"] for s in spans]
    assert names.count("request") == 2 and names.count("compile") == 1
    assert {"parse", "plan", "dispatch", "transfer"} <= set(names)
    assert [s["attrs"]["warm"] for s in spans if s["name"] == "request"] \
        == [False, True]


def test_observer_surfaces_overflow_retry(tree, sequence):
    """tests/test_obs.py's retry surfacing: the once-per-session warning
    (same text), the counter, the metric."""
    ref_ds, port_ds = tree
    msgs, stats = [], []
    for mod, ds, timing in ((ref, ref_ds, RefTiming),
                            (port, port_ds, port_engine.BucketTiming)):
        s = mod.ServingSession(ds, caps=caps(mod), calibrate_every=0)
        s.submit(P1, [0, 1])
        observe = s._observer(s.plan_for(P1, [0, 1]), calibrate=False)
        c = caps(mod)
        t = timing(index=0, lanes=1, padded_lanes=1, caps=c, retried=True,
                   elapsed_us=123.0, predicted_caps=type(c)(4, 8))
        with pytest.warns(RuntimeWarning, match="overflowed its predicted") \
                as w:
            observe(t)
        observe(t)                      # counted, not warned again
        msgs.append([str(x.message) for x in w])
        stats.append((stats_doc(s), metrics_doc(s)))
    assert msgs[1] == msgs[0]
    assert stats[1] == stats[0]
    assert stats[1][0]["overflow_retries"] == 2


def test_admission_ladder_degrades_as_reference(tree):
    """Budgets that degrade the hub roots: the same depth-clamped prefix
    lanes, the same classified report and the admission section stamped
    on the plan."""
    ref_ds, port_ds = tree
    roots = [0, 1, 2, 2999, 5]
    out = []
    for mod, ds in ((ref, ref_ds), (port, port_ds)):
        tight = mod.DEFAULT_CONSTANTS._replace(guard_degrade_us=20.0,
                                               guard_reject_us=1e12)
        s = mod.ServingSession(ds, caps=caps(mod), calibrate_every=0,
                               calibrator=mod.Calibrator(prior=tight))
        lanes = s.submit(P1, roots)
        out.append((lanes, report_doc(s.last_report), stats_doc(s),
                    s.plan_json(P1, roots)))
    (wl, wr, ws, wj), (gl, gr, gs, gj) = out
    for k, (g, w) in enumerate(zip(gl, wl)):
        assert_same_lane(g, w, f"degraded lane {k}")
    assert_doc_equal(gr, wr, skip=())
    assert gs == ws
    assert_doc_equal(gj, wj, skip=())
    assert gr["degraded_roots"] and gr["truncated"]


def test_front_door_errors_match_reference(tree):
    """Typed errors with the reference's messages: bad roots and depths at
    submit and enqueue, a full coalesced word, and a root the guards
    reject."""
    ref_ds, port_ds = tree
    msgs = []
    for mod, ds in ((ref, ref_ds), (port, port_ds)):
        s = mod.ServingSession(ds, caps=caps(mod), calibrate_every=0)
        got = []
        for bad in ([-1], [ds.num_vertices], [1.5], np.array(["x"])):
            with pytest.raises(mod.InvalidRequestError) as e:
                s.submit(P1, bad)
            got.append(str(e.value))
        with pytest.raises(mod.InvalidRequestError) as e:
            s.submit(P1.replace("t.depth < 4", "t.depth < 0"), [0])
        got.append(str(e.value))
        with pytest.raises(mod.InvalidRequestError) as e:
            s.enqueue(P1, 3000)
        got.append(str(e.value))
        for r in range(32):
            s.enqueue(P1, r)
        with pytest.raises(mod.InvalidRequestError) as e:
            s.enqueue(P1, 0)
        got.append(str(e.value))
        assert s.flush() == 1
        tight = mod.DEFAULT_CONSTANTS._replace(guard_degrade_us=1e-6,
                                               guard_reject_us=1e-3)
        strict = mod.ServingSession(ds, caps=caps(mod),
                                    calibrator=mod.Calibrator(prior=tight))
        with pytest.raises(mod.AdmissionError) as e:
            strict.enqueue(P1, 0)
        got.append(str(e.value))
        with pytest.raises(mod.AdmissionError) as e:
            strict.submit(P1, [0, 1])
        got.append(str(e.value))
        got.append(stats_doc(strict))
        got.append(stats_doc(s))
        msgs.append(got)
    assert msgs[1] == msgs[0]
    with pytest.raises(RuntimeError, match="flush"):
        port.ServingSession(port_ds).enqueue(P1, 0).result()


def test_degraded_result_shapes(tree, sequence):
    """The empty classified answer: cut from a sibling lane (every field's
    dtype kept, on the host) or minimal, as the reference's."""
    ref_s, port_s = sequence[2], sequence[3]
    lane = sequence[1][0]["out"][0]
    want_lane = sequence[0][0]["out"][0]
    got = port_s._degraded_result(lane)
    want = ref_s._degraded_result(want_lane)
    assert_same_lane(got, want, "cut")
    assert int(got.count) == 0 and got.positions.shape == (0,)
    assert_same_lane(port_s._degraded_result(), ref_s._degraded_result(),
                     "minimal")


def test_recalibrate_drops_choices_keeps_logical(tree):
    """``recalibrate`` refits and re-ranks: the choice, bucket and plan
    caches and the request memo are dropped, the logical cache kept (the
    constants it fits are timing-dependent, so only the caches are
    compared)."""
    _, port_ds = tree
    s = port.ServingSession(port_ds, caps=caps(port), calibrate_every=0)
    s.submit(P1, [0, 1])
    s.submit(P1, [0, 1])
    calls = dict(s.counters)
    s.recalibrate()
    assert (len(s._choice), len(s._bucket_plans), len(s._plans),
            len(s._requests)) == (0, 0, 0, 0)
    assert len(s._logical) == 1
    s.submit(P1, [0, 1])
    assert s.counters["parse_calls"] == calls["parse_calls"]
    assert s.counters["cost_calls"] > calls["cost_calls"]


def test_straggler_monitor_matches_reference():
    from repro.distributed.fault_tolerance import StragglerMonitor as Ref
    from repro_torch.distributed import StragglerMonitor
    times = [100.0, 90, 110, 95, 105, 400, 100, 98, 1000, 101]
    got, want = StragglerMonitor(), Ref()
    assert got.expected == want.expected == 0.0
    assert got.deadline == want.deadline == float("inf")
    for t in times:
        assert got.record(t) == want.record(t)
        assert (got.expected, got.deadline, got.stragglers) == \
            (want.expected, want.deadline, want.stragglers)
    assert got.stragglers == 2


def test_metrics_text_names_match_reference(sequence):
    """The Prometheus exposition: the same metric families and counter
    samples (histogram buckets and sums are times, left out)."""
    ref_s, port_s = sequence[2], sequence[3]

    def samples(text):
        out = []
        for line in text.splitlines():
            if line.startswith("#"):
                out.append(line)
            elif "_us" not in line.split(" ")[0]:
                out.append(line)
        return out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert samples(port_s.metrics_text()) == \
            samples(ref_s.metrics_text())


def eviction_graph():
    """100 dead-end sources of degree 1, and one more source of degree 1
    (vertex 200) whose only child fans out to 300 leaves: the statistics
    price vertex 200 like the dead ends, so its lane outgrows the bucket's
    caps while the others fit, and the executor evicts it alone."""
    src = list(range(1, 101)) + [200] + [201] * 300
    dst = [1000 + i for i in range(1, 101)] + [201] + \
        [2000 + j for j in range(300)]
    return both_datasets({"id": np.arange(len(src), dtype=np.int32),
                          "from": np.asarray(src, np.int32),
                          "to": np.asarray(dst, np.int32),
                          "name": np.zeros((len(src), 4), np.float32)},
                         2300)


def test_evicted_lane_is_served_where_the_reference_raises():
    """A bucket that evicts one overflowing lane: the reference's finish
    hook sees the evicted lane's stale overflow flag and raises; the port
    clears it and serves every lane, each equal (live rows, depth) to the
    reference's ``diropt`` run of its root at the session's caps, the
    eviction classified on the report."""
    ref_ds, port_ds = eviction_graph()
    roots = [3, 7, 200, 11]
    with pytest.raises(RuntimeError, match="capacity overflow"):
        ref.ServingSession(ref_ds, calibrate_every=0).submit(P1, roots)
    s = port.ServingSession(port_ds, calibrate_every=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = s.submit(P1, roots)
    assert s.last_report.evictions == 1 and not s.last_report.truncated
    assert s.stats["overflow_lane_evictions"] == 1
    q = s.plan_for(P1, roots).choice.query
    from repro.core.engine import RecursiveQuery, run_query
    for root, g in zip(roots, got):
        w = run_query(RecursiveQuery("diropt", q.max_depth, q.payload_cols,
                                     RefCaps(*q.caps)), ref_ds, root)
        n = int(w.count)
        assert (int(g.count), int(g.depth), bool(g.overflow)) == \
            (n, int(w.depth), False)
        assert g.values["id"][:n].tolist() == \
            np.asarray(w.values["id"])[:n].tolist()
        assert g.row_depths[:n].tolist() == \
            np.asarray(w.row_depths)[:n].tolist()
    assert int(got[2].count) == 301
