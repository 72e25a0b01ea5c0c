"""The port's persistent plan store (``repro_torch.planner.plan_store``)
against the live JAX reference's, and the chaos cases of the serving front
door on the port, on the CPU.

A store crosses between the packages in both directions: one the
reference writes loads in the port with zero parse / statistics / costing
passes and serves the same lanes bit for bit, and one the port writes
loads in the reference the same way.  ``graph_digest`` hashes the same
bytes.  The v1-v5 documents of tests/test_plan_store.py migrate to the
same v6 documents.  The two packages' store documents are equal but for
the timing-dependent ``calibration`` and ``kernel_factors_measured``
sections, left out by name (floats within a relative 1e-12, as in
``tests/test_torch_explain.py``).  The chaos cases of tests/test_chaos.py
arm the port's own fault points (``bucket_overflow``, ``straggler_sleep``,
``plan_store_corrupt``, ``calibrator_poison``) with budgets that leave no
doubt (a 50 ms sleep against a 20 ms deadline), and hold the non-faulted
lanes bit-equal to a fault-free port baseline that itself equals the
reference's.
"""
import json
import math
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.planner.plan_store as ref_store
from repro import planner as ref
from repro.core.engine import EngineCaps as RefCaps
from repro.planner.stats import compute_stats as ref_compute_stats
from repro_torch import planner as port
from repro_torch.core import engine as port_engine
from repro_torch.data.treegen import TreeSpec, make_edge_table
from repro_torch.obs import faultinject
from repro_torch.planner import plan_store as port_store
from repro_torch.planner.stats import compute_stats
from test_plan_store import _as_v1, _as_v2
from test_torch_engine import both_datasets, graph_columns
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_explain import assert_doc_equal
from test_torch_serving import assert_same_lane

CAPS = (1024, 2048)
SPEC = TreeSpec(num_vertices=300, height=6, payload_cols=2, seed=5)
SQL = ref.paper_listing(1, root=0, depth=4)
TRAFFIC = [[0, 1, 2], [0, 5, 17, 40], [0, 1, 2]]
TIMING_SECTIONS = ("calibration", "kernel_factors_measured")
ZERO = {"parse_calls": 0, "stats_calls": 0, "cost_calls": 0}


def caps(mod, c=CAPS):
    return RefCaps(*c) if mod is ref else port_engine.EngineCaps(*c)


def datasets(spec=SPEC):
    return both_datasets(make_edge_table(spec), spec.num_vertices)


def serve(mod, ds, path=None, traffic=TRAFFIC, **kw):
    s = mod.ServingSession(ds, caps=caps(mod), calibrate_every=0,
                           plan_store=path, **kw)
    out = [s.submit(SQL, roots) for roots in traffic]
    return s, out, [s.plan_json(SQL, roots) for roots in traffic]


def assert_same_traffic(got, want):
    for i, (g_req, w_req) in enumerate(zip(got, want)):
        assert len(g_req) == len(w_req)
        for k, (g, w) in enumerate(zip(g_req, w_req)):
            assert_same_lane(g, w, f"request {i} lane {k}")


# ---------------------------------------------------------------------------
# the store between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["tree", "multi3", "multi12"])
def test_graph_digest_matches_reference(graph):
    if graph == "tree":
        ref_ds, port_ds = datasets()
    else:
        g = dict(seed=int(graph[5:]), num_vertices=17 + int(graph[5:]),
                 num_edges=40)
        ref_ds, port_ds = both_datasets(graph_columns(**g),
                                        g["num_vertices"])
    assert port_store.graph_digest(port_ds) == \
        ref_store.graph_digest(ref_ds)


def test_reference_store_loads_in_port(tmp_path):
    """A store the reference wrote: the port's first requests pay no
    planning pass and serve the reference's lanes and plans."""
    path = str(tmp_path / "store.json")
    ref_ds, _ = datasets()
    cold, want, want_plans = serve(ref, ref_ds)
    ref_store.save_session(cold, path)
    _, port_ds = datasets()
    before = compute_stats.calls
    warm, got, got_plans = serve(port, port_ds, path)
    assert warm.counters == ZERO
    assert compute_stats.calls == before
    assert_same_traffic(got, want)
    assert_doc_equal(got_plans, want_plans, skip=())
    assert warm.calibrator.count >= cold.calibrator.count


def test_port_store_loads_in_reference(tmp_path):
    path = str(tmp_path / "store.json")
    _, port_ds = datasets()
    cold, got, got_plans = serve(port, port_ds)
    port.save_session(cold, path)
    ref_ds, _ = datasets()
    before = ref_compute_stats.calls
    warm, want, want_plans = serve(ref, ref_ds, path)
    assert warm.counters == ZERO
    assert ref_compute_stats.calls == before
    assert_same_traffic(got, want)
    assert_doc_equal(got_plans, want_plans, skip=())


def test_store_documents_match_reference():
    """The same traffic, the same store document (the timing-dependent
    sections left out by name)."""
    ref_ds, port_ds = datasets()
    want = json.loads(json.dumps(ref_store.session_to_json(
        serve(ref, ref_ds)[0])))
    got = json.loads(json.dumps(port_store.session_to_json(
        serve(port, port_ds)[0])))
    assert_doc_equal(got, want, skip=TIMING_SECTIONS)
    assert got["entries"] and got["shapes"] and got["stats"]


@pytest.mark.parametrize("seed", [0, 9])
def test_store_roundtrip_is_fixed_point(tmp_path, seed):
    """serialize -> rehydrate -> serialize gives the same document."""
    spec = SPEC._replace(seed=seed)
    _, ds = datasets(spec)
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, spec.num_vertices, 3).tolist()
               for _ in range(2)]
    session, _, _ = serve(port, ds, traffic=batches)
    doc1 = json.loads(json.dumps(port_store.session_to_json(session),
                                 sort_keys=True))
    path = str(tmp_path / "store.json")
    port.save_session(session, path)
    _, ds2 = datasets(spec)
    session2 = port.ServingSession(ds2, caps=caps(port))
    port_store.rehydrate_into(session2, path)
    doc2 = json.loads(json.dumps(port_store.session_to_json(session2),
                                 sort_keys=True))
    assert doc1 == doc2


def _as_v3(doc):
    v3 = json.loads(json.dumps(doc))
    v3["schema_version"] = 3
    v3.pop("analyze", None)
    return v3


def _as_v4(doc):
    v4 = json.loads(json.dumps(doc))
    v4["schema_version"] = 4
    for k in ("workload", "weight_col"):
        v4["logical"].pop(k, None)
    for c in v4["candidates"]:
        c.pop("semiring", None)
    return v4


def _as_v5(doc):
    v5 = json.loads(json.dumps(doc))
    v5["schema_version"] = 5
    v5.pop("admission", None)
    for k in ("guard_degrade_us", "guard_reject_us"):
        v5["cost_constants"].pop(k, None)
    return v5


OLD = {1: _as_v1, 2: _as_v2, 3: _as_v3, 4: _as_v4, 5: _as_v5}


@pytest.mark.parametrize("version", sorted(OLD))
def test_old_documents_migrate_as_reference(tmp_path, version):
    """A v1-v5 plan document migrates to the reference's v6 document and
    rebuilds the same ranking; a store of that version loads in the port
    with zero planning passes and serves the reference's lanes."""
    ref_ds, port_ds = datasets()
    cold, want, _ = serve(ref, ref_ds)
    old = OLD[version](cold.plan_json(SQL, TRAFFIC[0]))
    got_doc = port.migrate_plan_doc(old)
    assert_doc_equal(got_doc, ref.migrate_plan_doc(old), skip=())
    assert got_doc["schema_version"] == 6
    assert [c.label for c in port_store.report_from_json(old).ranked] == \
        [c.label for c in ref_store.report_from_json(old).ranked]

    path = str(tmp_path / "store.json")
    ref_store.save_session(cold, path)
    doc = json.loads(open(path).read())
    doc["schema_version"] = version
    doc["shapes"] = [OLD[version](s) for s in doc["shapes"]]
    for e in doc["entries"]:
        e["plan_json"] = OLD[version](e["plan_json"])
        if version <= 2:
            for c in e["bucket_choices"]:
                for k in ("plain_bytes", "kernel_bytes", "level_dirs"):
                    c["cost"].pop(k, None)
    with open(path, "w") as f:
        json.dump(doc, f)
    assert_doc_equal(port.load_store(path), ref.load_store(path), skip=())
    warm, got, _ = serve(port, port_ds, path)
    assert warm.counters == ZERO
    assert_same_traffic(got, want)


def test_migrate_rejects_unknown_versions():
    for doc in ({"schema_version": 99}, {"schema_version": None}):
        with pytest.raises(ValueError, match="schema_version") as want:
            ref.migrate_plan_doc(doc)
        with pytest.raises(ValueError, match="schema_version") as got:
            port.migrate_plan_doc(doc)
        assert str(got.value) == str(want.value)


def test_pre_v3_unkeyed_factor_fills_the_device_cell(tmp_path):
    """A pre-v3 store's one un-keyed kernel factor lands in the cell of
    the dataset's device type, and never over a measured one."""
    _, port_ds = datasets()
    cold, _, _ = serve(port, port_ds)
    path = str(tmp_path / "store.json")
    port.save_session(cold, path)
    doc = json.loads(open(path).read())
    doc.pop("kernel_factors_measured", None)
    doc["kernel_factor_measured"] = 2.5
    with open(path, "w") as f:
        json.dump(doc, f)
    cal = port.calibrate
    cal.set_measured_kernel_factor(None, backend="cpu")
    try:
        port.rehydrate_session(port_ds, path, caps=caps(port))
        assert cal.measured_kernel_factor(device="cpu") == 2.5
        cal.set_measured_kernel_factor(9.9, backend="cpu")
        port.rehydrate_session(datasets()[1], path, caps=caps(port))
        assert cal.measured_kernel_factor(device="cpu") == 9.9
    finally:
        cal.set_measured_kernel_factor(None, backend="cpu")


def test_rehydrate_refuses_a_different_graph(tmp_path):
    path = str(tmp_path / "store.json")
    ref_ds, _ = datasets()
    ref_store.save_session(serve(ref, ref_ds, traffic=[[0, 1]])[0], path)
    other = TreeSpec(num_vertices=301, height=6, payload_cols=2, seed=6)
    ref_other, port_other = datasets(other)
    with pytest.raises(ValueError, match="different graph") as want:
        ref.rehydrate_session(ref_other, path, caps=caps(ref))
    with pytest.raises(ValueError, match="different graph") as got:
        port.rehydrate_session(port_other, path, caps=caps(port))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# chaos: every injected fault ends classified, never in wrong rows
# ---------------------------------------------------------------------------

CHAOS_CAPS = (2048, 4096)
CHAOS_TREE = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
CHAOS_SQL = ref.paper_listing(1, root=0, depth=6)
ROOTS = [0, 1, 5, 77, 500, 1500, 2999]


@pytest.fixture(scope="module")
def chaos():
    """tests/test_chaos.py's tree and the port's fault-free baseline."""
    _, port_ds = datasets(CHAOS_TREE)
    base = chaos_session(port_ds).submit(CHAOS_SQL, ROOTS)
    return port_ds, base


def chaos_session(ds, **kw):
    return port.ServingSession(ds, caps=caps(port, CHAOS_CAPS), **kw)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faultinject.clear()
    yield
    assert not faultinject.armed(), "a chaos test leaked an armed fault"
    faultinject.clear()


def same_lanes(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same_lane(g, w, f"lane {k}")


def same_live_rows(got, want):
    """Lanes of one root at different caps (a retry reruns at the
    fallback caps): the loop accounting and the live rows bit for bit."""
    for k, (g, w) in enumerate(zip(got, want)):
        n = int(w.count)
        for field in ("count", "depth", "overflow"):
            assert torch.equal(getattr(g, field), getattr(w, field)), \
                (k, field)
        for field in ("positions", "row_depths"):
            assert torch.equal(getattr(g, field)[:n],
                               getattr(w, field)[:n]), (k, field)
        assert sorted(g.values) == sorted(w.values)
        for c, v in w.values.items():
            assert torch.equal(g.values[c][:n], v[:n]), (k, c)


def test_chaos_baseline_matches_reference(chaos):
    port_ds, base = chaos
    ref_ds, _ = datasets(CHAOS_TREE)
    want = ref.ServingSession(ref_ds, caps=caps(ref, CHAOS_CAPS)).submit(
        CHAOS_SQL, ROOTS)
    same_lanes(base, want)


def test_forced_overflow_retries_and_keeps_rows(chaos):
    ds, base = chaos
    session = chaos_session(ds)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faultinject.injected("bucket_overflow", times=1):
            out = session.submit(CHAOS_SQL, ROOTS)
    assert session.last_report.retries >= 1
    assert session.stats["retry_budget_spent"] >= 1
    same_live_rows(out, base)


def test_straggler_under_deadline_truncates_with_parity(chaos):
    ds, base = chaos
    session = chaos_session(ds)
    session.submit(CHAOS_SQL, ROOTS)            # warm the plan
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with faultinject.injected("straggler_sleep", 0.05, times=None):
            out = session.submit(CHAOS_SQL, ROOTS, deadline_us=20_000.0)
    rep = session.last_report
    assert rep.truncated and rep.skipped_buckets >= 1 and rep.skipped_roots
    assert session.stats["deadline_skipped_buckets"] >= 1
    assert any("deadline" in str(x.message).lower() for x in w)
    skipped = set(rep.skipped_roots)
    for root, got, want in zip(ROOTS, out, base):
        if root in skipped:
            assert int(got.count) == 0
            # the empty answer keeps a sibling lane's columns and dtypes
            assert sorted(got.values) == sorted(want.values)
            for k, v in got.values.items():
                assert v.dtype == want.values[k].dtype and v.numel() == 0
        else:
            assert_same_lane(got, want, f"root {root}")


def test_no_deadline_means_no_truncation(chaos):
    ds, base = chaos
    session = chaos_session(ds)
    with faultinject.injected("straggler_sleep", 0.01, times=2):
        out = session.submit(CHAOS_SQL, ROOTS)
    assert not session.last_report.truncated
    same_lanes(out, base)


def test_corrupt_plan_store_cold_starts_and_recovers(chaos, tmp_path):
    ds, base = chaos
    path = str(tmp_path / "store.json")
    writer = chaos_session(ds)
    writer.submit(CHAOS_SQL, ROOTS)
    port.save_session(writer, path)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with faultinject.injected("plan_store_corrupt"):
            session = chaos_session(ds, plan_store=path)
    assert any("cold-start" in str(x.message) for x in w)
    assert not session._plans
    same_lanes(session.submit(CHAOS_SQL, ROOTS), base)
    port.save_session(session, path)
    assert port.load_store(path)["schema_version"] >= 6


@pytest.mark.parametrize("garbage", [
    "", "{not json", '{"kind": "plan_store"',
    json.dumps({"kind": "something_else"}),
    json.dumps({"kind": "plan_store", "schema_version": 99}),
])
def test_garbage_store_bytes_cold_start(chaos, tmp_path, garbage):
    ds, _ = chaos
    path = str(tmp_path / "store.json")
    with open(path, "w") as f:
        f.write(garbage)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        session = chaos_session(ds, plan_store=path)
    assert any("cold-start" in str(x.message) for x in w)
    assert int(session.submit(CHAOS_SQL, [0])[0].count) > 0


def test_direct_load_still_raises_typed(tmp_path):
    path = str(tmp_path / "store.json")
    with open(path, "w") as f:
        f.write("{definitely not json")
    with pytest.raises(json.JSONDecodeError):
        port.load_store(path)


@pytest.mark.parametrize("poison", [float("nan"), float("inf"), -5.0])
def test_poisoned_observations_never_corrupt_constants(chaos, poison):
    ds, base = chaos
    session = chaos_session(ds, calibrate_every=4)
    with faultinject.injected("calibrator_poison", poison, times=None):
        for _ in range(3):
            out = session.submit(CHAOS_SQL, ROOTS)
    cal = session.calibrator
    assert cal.discarded > 0 and cal.count == 0
    c = cal.constants
    for v in (c.base_us, c.level_us, c.bytes_per_us, c.kernel_factor):
        assert v is None or (math.isfinite(v) and v > 0)
    same_lanes(out, base)


def test_huge_but_finite_poison_cannot_flip_constants_sign(chaos):
    ds, _ = chaos
    session = chaos_session(ds, calibrate_every=4)
    with faultinject.injected("calibrator_poison", 1e12, times=None):
        for _ in range(8):
            session.submit(CHAOS_SQL, ROOTS)
    c = session.calibrator.constants
    for v in (c.base_us, c.level_us, c.bytes_per_us, c.kernel_factor):
        assert v is None or (math.isfinite(v) and v > 0)


def test_garbage_roots_typed_then_session_still_serves(chaos):
    ds, base = chaos
    session = chaos_session(ds)
    for bad in ([-1], [ds.num_vertices], [1.5], np.array(["x"])):
        with pytest.raises(port.InvalidRequestError):
            session.submit(CHAOS_SQL, bad)
    same_lanes(session.submit(CHAOS_SQL, ROOTS), base)


def test_rejected_root_leaves_other_requests_untouched(chaos):
    ds, base = chaos
    tight = port.DEFAULT_CONSTANTS._replace(guard_degrade_us=1e-6,
                                            guard_reject_us=1e-3)
    session = chaos_session(ds, calibrator=port.Calibrator(prior=tight))
    with pytest.raises(port.AdmissionError):
        session.submit(CHAOS_SQL, ROOTS)
    session.guards = False
    same_lanes(session.submit(CHAOS_SQL, ROOTS), base)


def test_store_file_is_written_atomically(chaos, tmp_path, monkeypatch):
    """A writer that dies mid-write leaves the old store and no temp
    file."""
    ds, _ = chaos
    path = str(tmp_path / "store.json")
    session = chaos_session(ds)
    session.submit(CHAOS_SQL, [0, 1])
    port.save_session(session, path)
    before = open(path).read()

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(port_store.json, "dump", boom)
    with pytest.raises(OSError, match="disk full"):
        port.save_session(session, path)
    assert open(path).read() == before
    assert os.listdir(tmp_path) == ["store.json"]
