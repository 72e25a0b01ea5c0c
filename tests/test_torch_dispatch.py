"""The bucket executor and the observability package: the port's
``dispatch_buckets`` / ``run_query_buckets`` and ``repro_torch.obs``
against the JAX reference's, on the CPU.

Each case runs the same buckets through both executors and compares the
per-root results on every field (bit for bit; nothing here does float
arithmetic, so the tolerance is 0), the ``DispatchReport``, every
``BucketTiming`` field but ``elapsed_us`` (a wall-clock time), and the
deltas of ``overflow_retry_count`` and ``lane_eviction_count``.  Buckets
are plain dataclasses with ``indices``, ``roots`` and ``caps``, the three
fields the executor reads.  Every path of the executor runs: full-bucket
retry, per-lane eviction (of batch lanes and of MS-BFS lanes), a retry
denied by a ``RetryPolicy(budget=0)``, geometric ``growth``, ``deadline_us``
skips with ``SKIPPED`` lanes, a duck-typed straggler monitor, the
``finish`` hook, ``to_host``, and the ``bucket_overflow`` and
``straggler_sleep`` fault points armed in both packages.  The tracers of
the two packages must record the same spans and events (names, ids,
parents and attributes; times excluded).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.engine as ref
import repro.obs as ref_obs
import repro_torch.core.engine as port
import repro_torch.obs as port_obs
from repro.obs import faultinject as ref_fault
from repro_torch.data.treegen import TreeSpec, bfs_reference, make_edge_table
from repro_torch.obs import faultinject as port_fault
from test_torch_engine import assert_same_result, both_datasets
from test_torch_engine import release_reference_executables  # noqa: F401

V = 3000

E_SPEC = TreeSpec(num_vertices=V, height=10, payload_cols=2, seed=11)


@dataclasses.dataclass(frozen=True)
class Bucket:
    indices: tuple
    roots: tuple
    caps: tuple


@pytest.fixture(scope="module")
def tree():
    cols = make_edge_table(E_SPEC)
    ref_ds, port_ds = both_datasets(cols, V)
    levels = bfs_reference(cols["from"], cols["to"], 0, 10, V)
    leaves = sorted({int(cols["to"][i]) for i in
                     [lv for lv in levels if lv][-1]})[:3]
    return ref_ds, port_ds, cols, leaves


def full_caps(cols):
    e = cols["id"].shape[0]
    return (e + 8, 4 * e + 8)


def query(engine, caps, direction="outbound", depth=10):
    return (ref.RecursiveQuery(engine, depth, 2, ref.EngineCaps(*caps),
                               direction=direction),
            port.RecursiveQuery(engine, depth, 2, port.EngineCaps(*caps),
                                direction=direction))


def dispatcher(mod, q, ds, multi: bool):
    """``dispatch(i, b, caps)`` of one package: a batch, or an MS-BFS word,
    of the bucket's roots at ``caps``."""
    def _dispatch(i, b, caps):
        qb = dataclasses.replace(q, caps=caps) if caps != q.caps else q
        if multi:
            qb = dataclasses.replace(qb, engine="multiquery",
                                     lanes=len(b.roots))
            return mod.run_query_multi(qb, ds, np.asarray(b.roots, np.int32))
        return mod.run_query_batch(qb, ds, list(b.roots))
    return _dispatch


def as_buckets(mod, specs):
    return [Bucket(tuple(ix), tuple(roots), mod.EngineCaps(*caps))
            for ix, roots, caps in specs]


def run_both(tree, engine, specs, fallback, *, multi=False, faults=(),
             policy=None, monitor=None, **kwargs):
    """The same buckets through both executors (``monitor``, a class, gives
    each its own straggler monitor); returns, per package, the per-root
    results, the report, the timings, the counter deltas, the finish
    hook's calls and the monitor."""
    ref_ds, port_ds, _, _ = tree
    rq, pq = query(engine, fallback)
    out = {}
    for name, mod, ds, q, fault in (("ref", ref, ref_ds, rq, ref_fault),
                                    ("port", port, port_ds, pq, port_fault)):
        timings, finished = [], []
        report = mod.DispatchReport()
        straggler = None if monitor is None else monitor()

        def finish(i, b, r, finished=finished):
            finished.append((i, tuple(b.indices), tuple(b.roots)))
            return r
        before = (mod.overflow_retry_count(), mod.lane_eviction_count())
        for point, value, times in faults:
            fault.inject(point, value, times=times)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got = mod.dispatch_buckets(
                    as_buckets(mod, specs), dispatcher(mod, q, ds, multi),
                    fallback_caps=mod.EngineCaps(*fallback),
                    observer=timings.append, report=report, finish=finish,
                    retry=None if policy is None else mod.RetryPolicy(
                        **policy), straggler=straggler, **kwargs)
        finally:
            fault.clear()
        out[name] = dict(
            results=got, report=report, timings=timings, finished=finished,
            monitor=straggler, deltas=(mod.overflow_retry_count() - before[0],
                    mod.lane_eviction_count() - before[1]))
    return out


def timing_fields(t):
    d = dataclasses.asdict(t)
    d.pop("elapsed_us")
    return {k: (tuple(v) if isinstance(v, (tuple, list)) else v)
            for k, v in d.items()}


def assert_same_dispatch(out):
    r, p = out["ref"], out["port"]
    assert len(p["results"]) == len(r["results"])
    for got, want in zip(p["results"], r["results"]):
        if want is ref.SKIPPED:
            assert got is port.SKIPPED
            continue
        assert_same_result(got, want)
    assert dataclasses.asdict(p["report"]) == dataclasses.asdict(r["report"])
    assert p["report"].truncated == r["report"].truncated
    assert [timing_fields(t) for t in p["timings"]] == \
        [timing_fields(t) for t in r["timings"]]
    assert p["deltas"] == r["deltas"]
    assert p["finished"] == r["finished"]


def test_full_bucket_retry(tree):
    """A one-lane bucket and a bucket whose every lane overflows run again
    whole at the fallback caps; a fitting bucket is left alone."""
    _, _, cols, leaves = tree
    tiny = (4, 8)
    out = run_both(tree, "precursive",
                   [((0,), (0,), tiny), ((1, 2), (0, 1), tiny),
                    ((3, 4), tuple(leaves[:2]), tiny)], full_caps(cols))
    assert_same_dispatch(out)
    assert out["port"]["deltas"] == (2, 0)
    assert out["port"]["report"].retries == 2


@pytest.mark.parametrize("multi", [False, True], ids=["batch", "msbfs"])
def test_per_lane_eviction(tree, multi):
    """Only the overflowing lane leaves its bucket, for a solo run at the
    fallback caps; the leaf lanes keep their bucket-caps rows."""
    _, _, cols, leaves = tree
    e = cols["id"].shape[0]
    bucket = ((0, 1, 2, 3), (0, *leaves), (e + 8, 4))
    engine = "diropt" if multi else "precursive"
    out = run_both(tree, engine, [bucket], full_caps(cols), multi=multi)
    assert_same_dispatch(out)
    assert out["port"]["deltas"] == (0, 1)
    assert out["port"]["timings"][0].evicted_lanes == 1


@pytest.mark.parametrize("multi", [False, True], ids=["batch", "msbfs"])
def test_retry_denied_by_budget(tree, multi):
    """A spent budget refuses the retry (whole bucket) and the eviction
    (per lane): the rows stay truncated and the report says so."""
    _, _, cols, leaves = tree
    e = cols["id"].shape[0]
    engine = "diropt" if multi else "precursive"
    out = run_both(tree, engine,
                   [((0,), (0,), (e + 8, 4)),
                    ((1, 2, 3), (0, leaves[0], leaves[1]), (e + 8, 4))],
                   full_caps(cols), multi=multi, policy=dict(budget=0))
    assert_same_dispatch(out)
    rep = out["port"]["report"]
    assert rep.denied_buckets == [0, 1] and rep.denied_lanes == [0, 1]
    assert rep.truncated and out["port"]["deltas"] == (0, 0)


def test_geometric_growth(tree):
    """``growth`` walks the caps up toward the fallback, one retry at a
    time, until the bucket fits."""
    _, _, cols, leaves = tree
    out = run_both(tree, "bitmap", [((0,), (0,), (8, 16)),
                                    ((1,), (leaves[0],), (8, 16))],
                   full_caps(cols), policy=dict(max_attempts=12, growth=4.0))
    assert_same_dispatch(out)
    assert out["port"]["report"].retries >= 2


def test_deadline_skips_and_stragglers(tree):
    """Under ``deadline_us`` the first bucket always runs and the rest are
    SKIPPED once the budget is spent; a straggler monitor (duck-typed:
    ``expected`` and ``record``) flags buckets as its record says."""
    _, _, cols, leaves = tree
    caps = full_caps(cols)
    specs = [((0, 2), (0, leaves[0]), caps), ((1,), (leaves[1],), caps),
             ((3,), (leaves[2],), caps)]
    out = run_both(tree, "precursive", specs, caps, deadline_us=0.0)
    assert_same_dispatch(out)
    assert out["port"]["report"].skipped_buckets == [1, 2]
    assert out["port"]["results"][1] is port.SKIPPED

    class Monitor:
        expected = 0.0

        def __init__(self):
            self.seen = 0

        def record(self, elapsed_us):
            self.seen += 1
            return self.seen == 2

    out = run_both(tree, "precursive", specs, caps, deadline_us=1e15,
                   monitor=Monitor)
    assert_same_dispatch(out)
    assert out["port"]["report"].straggler_buckets == [1]
    assert out["port"]["monitor"].seen == out["ref"]["monitor"].seen == 3


def test_fault_points(tree):
    """``bucket_overflow`` forces the retry of a bucket that fits, and
    ``straggler_sleep`` sleeps inside its timed interval, in both packages,
    each consulting its own registry; both disarm after firing."""
    _, _, cols, leaves = tree
    e = cols["id"].shape[0]
    small = (e + 8, 2 * e)
    out = run_both(tree, "precursive",
                   [((0, 1), (leaves[0], leaves[1]), small),
                    ((2,), (leaves[2],), small)], full_caps(cols),
                   faults=(("bucket_overflow", True, 1),
                           ("straggler_sleep", 0.002, 1)))
    assert_same_dispatch(out)
    assert out["port"]["deltas"] == (1, 0)
    assert out["port"]["timings"][0].retried
    assert out["port"]["timings"][0].elapsed_us >= 2000
    assert not port_fault.armed() and not ref_fault.armed()
    assert port_fault.FAULT_POINTS == ref_fault.FAULT_POINTS
    with pytest.raises(ValueError):
        port_fault.inject("nope")
    with port_fault.injected("calibrator_poison", float("nan"), times=2):
        assert np.isnan(port_fault.consume("calibrator_poison"))
        assert port_fault.armed()
    assert not port_fault.armed()


def test_to_host_and_cover_check(tree):
    """``to_host=True`` gives CPU results equal to the plain ones; buckets
    that do not cover every lane raise ValueError in both packages."""
    _, _, cols, leaves = tree
    caps = full_caps(cols)
    out = run_both(tree, "bitmap", [((1, 0), (0, leaves[0]), caps)], caps,
                   to_host=True)
    assert_same_dispatch(out)
    assert all(not r.count.is_cuda for r in out["port"]["results"])
    ref_ds, port_ds, _, _ = tree
    rq, pq = query("bitmap", caps)
    for mod, ds, q in ((ref, ref_ds, rq), (port, port_ds, pq)):
        with pytest.raises(ValueError, match="do not cover"):
            mod.dispatch_buckets(
                as_buckets(mod, [((0, 0), (0, 1), caps)]),
                dispatcher(mod, q, ds, False),
                fallback_caps=mod.EngineCaps(*caps))


@pytest.mark.parametrize("engine", ["precursive", "diropt"])
def test_run_query_buckets(tree, engine):
    """``run_query_buckets`` over four buckets, two at smaller caps (root
    0's too small, so it runs again at the query's): every root's result
    equals the reference's, and its rows the port's own single-root run's
    (a bucket that fit keeps its smaller result buffer)."""
    ref_ds, port_ds, cols, leaves = tree
    caps = full_caps(cols)
    roots = [0, *leaves, 17, 2999, -2, 3003]
    specs = [((0, 4), (0, 17), (64, 256)), ((1, 2), tuple(leaves[:2]), caps),
             ((3, 5), (leaves[2], 2999), (64, 256)),
             ((6, 7), (-2, 3003), caps)]
    rq, pq = query(engine, caps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref.run_query_buckets(rq, ref_ds, as_buckets(ref, specs))
        got = port.run_query_buckets(pq, port_ds, as_buckets(port, specs))
    for i, root in enumerate(roots):
        assert_same_result(got[i], want[i])
        one = port.run_query(pq, port_ds, root)
        n = int(one.count)
        for field in ("count", "depth", "overflow"):
            assert torch.equal(getattr(got[i], field), getattr(one, field))
        for field in ("positions", "row_depths"):
            assert torch.equal(getattr(got[i], field)[:n],
                               getattr(one, field)[:n])


def test_weighted_buckets_wait_for_their_slice(tree):
    """A weighted query's buckets raise the NotImplementedError of
    run_query_batch until the weighted batches are ported."""
    _, port_ds, cols, _ = tree
    caps = full_caps(cols)
    q = port.RecursiveQuery("bitmap", 4, 2, port.EngineCaps(*caps),
                            workload="shortest_path", weight_col="payload0")
    with pytest.raises(NotImplementedError, match="weighted"):
        port.run_query_buckets(q, port_ds, as_buckets(
            port, [((0,), (0,), caps)]))


def test_retry_warns_once_per_process(tree):
    """The first overflow retry warns (RuntimeWarning) and later ones only
    count, in both packages."""
    ref_ds, port_ds, cols, _ = tree
    caps = full_caps(cols)
    for mod, ds in ((ref, ref_ds), (port, port_ds)):
        q = query("precursive", caps)[mod is port]
        buckets = as_buckets(mod, [((0,), (0,), (4, 8))])
        mod._overflow_state["warned"] = False
        before = mod.overflow_retry_count()
        with pytest.warns(RuntimeWarning, match="overflowed its predicted"):
            mod.run_query_buckets(q, ds, buckets)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.run_query_buckets(q, ds, buckets)
        assert mod.overflow_retry_count() == before + 2


def test_retry_policy_and_report_match_reference():
    fb = (100, 1000)
    for kw in (dict(), dict(growth=2.0, max_attempts=4),
               dict(growth=3.0, max_attempts=2), dict(budget=1)):
        a, b = ref.RetryPolicy(**kw), port.RetryPolicy(**kw)
        for attempt in (1, 2, 3):
            assert tuple(b.next_caps(attempt, port.EngineCaps(7, 30),
                                     port.EngineCaps(*fb))) == \
                tuple(a.next_caps(attempt, ref.EngineCaps(7, 30),
                                  ref.EngineCaps(*fb)))
        assert [b.spend() for _ in range(3)] == [a.spend() for _ in range(3)]
        assert b.spent == a.spent
    assert dataclasses.asdict(port.DispatchReport()) == \
        dataclasses.asdict(ref.DispatchReport())
    assert [f.name for f in dataclasses.fields(port.BucketTiming)] == \
        [f.name for f in dataclasses.fields(ref.BucketTiming)]
    assert not port.DispatchReport().truncated
    assert port.DispatchReport(denied_buckets=[0]).truncated


def records(tracer):
    """A tracer's records without their times (``ts_us``, ``dur_us`` and
    the executor's measured ``elapsed_us``)."""
    out = []
    for rec in tracer.records:
        rec = {k: v for k, v in rec.items() if k not in ("ts_us", "dur_us")}
        rec["attrs"] = {k: v for k, v in rec["attrs"].items()
                        if k != "elapsed_us"}
        out.append(rec)
    return out


def traced(mod, obs, fn):
    t = obs.Tracer(meta={"run": "parity"})
    prev = obs.set_tracer(t)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = fn()
    finally:
        obs.set_tracer(prev)
    return t, r


@pytest.mark.parametrize("call", ["run_query", "run_query_diropt",
                                  "run_query_batch", "run_query_multi",
                                  "dispatch"])
def test_tracer_records_match_reference(tree, call):
    """Same span and event names, ids, parents and attributes as the
    reference's tracer, and level events whose edges sum to the rows."""
    ref_ds, port_ds, cols, leaves = tree
    caps = full_caps(cols)
    e = cols["id"].shape[0]
    roots = [0, leaves[0], 17]

    def run(mod, ds):
        if call == "dispatch":
            specs = [((0, 1, 2), (0, leaves[0], leaves[1]), (e + 8, 4)),
                     ((3,), (0,), (4, 8))]
            q = query("diropt", caps)[mod is port]
            return mod.dispatch_buckets(
                as_buckets(mod, specs), dispatcher(mod, q, ds, True),
                fallback_caps=mod.EngineCaps(*caps))
        engine = {"run_query": "bitmap", "run_query_diropt": "diropt",
                  "run_query_batch": "hybrid",
                  "run_query_multi": "multiquery"}[call]
        q = query(engine, caps, direction="inbound" if call ==
                  "run_query_batch" else "outbound")[mod is port]
        if call.startswith("run_query_") and call != "run_query_diropt":
            return getattr(mod, call)(q, ds, np.asarray(roots, np.int32))
        return mod.run_query(q, ds, 0)

    tr, want = traced(ref, ref_obs, lambda: run(ref, ref_ds))
    tp, got = traced(port, port_obs, lambda: run(port, port_ds))
    assert records(tp) == records(tr)
    assert tp.records and any(r["name"] == "dispatch" for r in tp.records)
    levels = [r for r in tp.records if r["name"] == "level"]
    assert levels
    if call != "dispatch":
        assert sum(r["attrs"]["edges"] for r in levels) == \
            int(got.count.sum())
    assert list(tp.iter_records())[0]["schema_version"] == \
        list(tr.iter_records())[0]["schema_version"]
    assert tp.chrome_trace()["otherData"] == tr.chrome_trace()["otherData"]


def test_untraced_path_records_nothing(tree, tmp_path):
    """No tracer installed: the entry points run as before and nothing is
    recorded; a disabled tracer is no tracer; the JSONL roundtrip reads
    back what was written."""
    _, port_ds, cols, _ = tree
    assert port_obs.current_tracer() is None
    q = query("bitmap", full_caps(cols))[1]
    port.run_query(q, port_ds, 0)
    off = port_obs.Tracer(enabled=False)
    prev = port_obs.set_tracer(off)
    try:
        assert port_obs.current_tracer() is None
        assert port_obs.trace_span("a") is port_obs.trace_span("b")
        port.run_query(q, port_ds, 0)
    finally:
        port_obs.set_tracer(prev)
    assert off.records == []
    t, _ = traced(port, port_obs, lambda: port.run_query(q, port_ds, 0))
    path = t.write_jsonl(str(tmp_path / "t.jsonl"))
    back = port_obs.read_jsonl(path)
    assert back[0]["type"] == "header" and back[1:] == t.records


def test_metrics_match_reference():
    """Counter, gauge and histogram values, snapshots and the Prometheus
    text of the port's registry equal the reference's."""
    regs = (ref_obs.MetricsRegistry(), port_obs.MetricsRegistry())
    for reg in regs:
        c = reg.counter("repro_x_total", "help text")
        c.inc()
        c.inc(3)
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("repro_g", "a gauge")
        g.set(7)
        g.inc(-2)
        h = reg.histogram("repro_lat_us", "latency")
        for v in range(1, 1001):
            h.observe(float(v))
        h.observe(1e12)
        with pytest.raises(TypeError):
            reg.gauge("repro_x_total")
    a, b = regs
    assert b.to_dict() == a.to_dict()
    assert b.render_text() == a.render_text()
    assert b.get("repro_lat_us").snapshot() == a.get("repro_lat_us").snapshot()
    for q in (0.5, 0.95, 0.99):
        assert b.get("repro_lat_us").quantile(q) == \
            a.get("repro_lat_us").quantile(q)
