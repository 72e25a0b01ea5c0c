"""The port's planner (``repro_torch.planner``: parser, statistics, caps,
buckets, ranking and ``plan_and_run``) against the JAX reference's.

Inputs are made from numpy seeds and carried into both packages.
Tolerances: parse trees, logical queries, statistics (the same float64
numpy arithmetic in the same order), root estimates, ``stats_digest``,
caps, buckets, ranked labels and skipped reasons are exactly equal;
``est_us`` within a relative 1e-12; ``plan_and_run`` results bit-equal in
every dressed column (``depth`` and ``value`` included), in ``count``,
``overflow`` and the other result fields (the golden tree is a forest, so
even the (sum, ×) values combine one arrival a vertex).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import Dataset
from repro.core.table import ColumnTable
from repro.data.treegen import TreeSpec, make_edge_table
from repro import planner as ref
from repro.planner.ast import weighted_listing as ref_weighted_listing
from repro_torch import planner as port
from repro_torch.convert import dataset_from_numpy
from repro_torch.core import engine as port_engine
from test_torch_engine import DIRECTIONS, assert_same_result, graph_columns
from test_torch_engine import release_reference_executables  # noqa: F401

GOLDEN = TreeSpec(num_vertices=3000, height=10, payload_cols=4, seed=11)
MULTIGRAPHS = (dict(seed=3, num_vertices=17, num_edges=40),
               dict(seed=12, num_vertices=29, num_edges=70),
               dict(seed=5, num_vertices=40, num_edges=160))
KERNEL_FACTORS = (0.0, 0.5, 3.0, 200.0)


def both(cols, num_vertices):
    """The reference's dataset and the port's CPU dataset of ``cols``."""
    r = Dataset.prepare(ColumnTable.from_numpy(cols), num_vertices)
    carried = {k: np.asarray(v) for k, v in r.table.columns.items()}
    return r, dataset_from_numpy(carried, num_vertices, "cpu")


def edge_columns(src, dst):
    e = len(src)
    return {"id": np.arange(e, dtype=np.int32),
            "from": np.asarray(src, np.int32),
            "to": np.asarray(dst, np.int32),
            "name": np.zeros((e, 4), np.float32)}


@pytest.fixture(scope="module")
def golden():
    """The golden tree (tests/test_planner.py's) with a seeded float32
    weight column ``w``."""
    cols = {k: np.asarray(v) for k, v in
            make_edge_table(GOLDEN).columns.items()}
    cols["w"] = np.random.default_rng(11).uniform(
        0.5, 2.0, GOLDEN.num_edges).astype(np.float32)
    return both(cols, GOLDEN.num_vertices)


GRAPHS = {
    "ring": (edge_columns([0, 1, 2, 3], [1, 2, 3, 0]), 4),
    "diamond": (edge_columns([0, 0, 1, 2], [1, 2, 3, 3]), 4),
    **{f"multi{g['seed']}": (graph_columns(**g), g["num_vertices"])
       for g in MULTIGRAPHS},
}


@pytest.fixture(scope="module")
def graphs():
    return {name: both(*g) for name, g in GRAPHS.items()}


def as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def directed(sql: str, direction: str) -> str:
    """A listing's text turned to ``inbound`` (seed on ``to``, join on
    ``e.to = t.from``) or ``both`` (the OR join)."""
    if direction == "inbound":
        return (sql.replace('WHERE "from" =', 'WHERE "to" =')
                .replace('e."from" = t."to"', 'e."to" = t."from"'))
    if direction == "both":
        return sql.replace('e."from" = t."to"',
                           'e."from" = t."to" OR e."to" = t."from"')
    return sql


LISTINGS = {
    "p1": lambda **k: ref.paper_listing(1, **k),
    "p2": lambda **k: ref.paper_listing(2, payload_cols=4, **k),
    "p3": lambda **k: ref.paper_listing(3, **k),
    "sssp": lambda **k: ref_weighted_listing("shortest_path", **k),
    "sum": lambda **k: ref_weighted_listing("aggregate_sum", **k),
}
WEIGHTED = ("sssp", "sum")

PARSE_CASES = {
    **{f"{name}-{d}": directed(make(root=3, depth=7), d)
       for name, make in LISTINGS.items() for d in DIRECTIONS},
    "p2-n3": ref.paper_listing(2, root=0, depth=5, payload_cols=3),
    "min": ref_weighted_listing("aggregate_min", depth=4),
    "max": ref_weighted_listing("aggregate_max", depth=4),
    "mul": ref_weighted_listing("aggregate_mul", depth=4),
    "le": ref.paper_listing(1, depth=6).replace("t.depth < 6",
                                                "t.depth <= 6"),
    "filter-le": ref.paper_listing(1, depth=9) + " WHERE depth <= 2",
    "filter-lt": ref.paper_listing(1, depth=9) + " WHERE depth < 2",
    "inbound-union": """
        WITH RECURSIVE t (id, "from", "to", depth) AS (
          SELECT id, "from", "to", 0 FROM edges WHERE "to" = 5
          UNION
          SELECT e.id, e."from", e."to", t.depth + 1
          FROM edges e JOIN t ON e."to" = t."from" WHERE t.depth < 4
        ) SELECT * FROM t""",
    "both-unbounded": """
        WITH RECURSIVE t (id, "from", "to") AS (
          SELECT id, "from", "to" FROM edges WHERE "from" = 5
          UNION
          SELECT e.id, e."from", e."to" FROM edges e
          JOIN t ON e."from" = t."to" OR e."to" = t."from"
        ) SELECT * FROM t""",
    "param-root": ref.paper_listing(1, depth=3).replace(
        'WHERE "from" = 0', 'WHERE "from" = :root'),
    "column3": """
        WITH RECURSIVE t (id, "to", column3, depth) AS (
          SELECT id, "to", column3, 0 FROM edges WHERE "from" = 0
          UNION ALL
          SELECT e.id, e."to", e.column3, t.depth + 1
          FROM edges e JOIN t ON e."from" = t."to" WHERE t.depth < 3
        ) SELECT * FROM t""",
    # tests/test_planner.py::test_parse_errors and its neighbours
    "err-with": "SELECT 1",
    "err-join": ("WITH RECURSIVE t AS (SELECT id FROM edges WHERE "
                 "\"from\" = 0 UNION ALL SELECT e.id FROM edges e JOIN t "
                 "ON e.name = t.id) SELECT * FROM t"),
    "err-outer": ("WITH RECURSIVE t (id) AS (SELECT id FROM edges WHERE "
                  "\"from\" = 0 UNION ALL SELECT e.id FROM edges e JOIN t "
                  "ON e.\"from\" = t.\"to\") SELECT * FROM wrong"),
    "err-contradicts": """
        WITH RECURSIVE t (id) AS (
          SELECT id FROM edges WHERE "to" = 0
          UNION ALL
          SELECT e.id FROM edges e JOIN t ON e."from" = t."to"
        ) SELECT * FROM t""",
    "err-token": "WITH RECURSIVE t AS (SELECT $ FROM edges)",
    "err-empty": "",
}


def outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:              # the two packages' own types
        return ("raise", type(e).__name__, str(e))


def same_outcome(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raise":
        assert got == want
    else:
        assert as_dict(got[1]) == as_dict(want[1])
    return got


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_trees_match_reference(case):
    sql = PARSE_CASES[case]
    got = same_outcome(outcome(port.parse, sql), outcome(ref.parse, sql))
    if case.startswith("err-"):
        assert got[0] == "raise" and got[1] == "ParseError"


@pytest.mark.parametrize("n", [1, 2, 3])
def test_listing_text_matches_reference(n):
    for kw in (dict(), dict(root=9, depth=3, payload_cols=5)):
        assert port.paper_listing(n, **kw) == ref.paper_listing(n, **kw)
    for w in ("shortest_path", "aggregate_sum", "aggregate_mul"):
        assert (port.weighted_listing(w, root=2, depth=5, weight_col="q")
                == ref_weighted_listing(w, root=2, depth=5, weight_col="q"))
    same_outcome(outcome(port.paper_listing, 4),
                 outcome(ref.paper_listing, 4))
    same_outcome(outcome(port.weighted_listing, "aggregate_avg"),
                 outcome(ref_weighted_listing, "aggregate_avg"))


NORMALIZE_CASES = sorted(k for k in PARSE_CASES if not k.startswith("err"))


@pytest.mark.parametrize("case", NORMALIZE_CASES)
def test_normalize_matches_reference_on_golden_tree(golden, case):
    r, p = golden
    sql = PARSE_CASES[case]
    for kw in (dict(), dict(root=17, default_max_depth=5)):
        same_outcome(outcome(port.normalize, port.parse(sql), p, **kw),
                     outcome(ref.normalize, ref.parse(sql), r, **kw))


UNION_ALL_RING = """
    WITH RECURSIVE t (id, "from", "to", depth) AS (
      SELECT id, "from", "to", 0 FROM edges WHERE "from" = 0
      UNION ALL
      SELECT e.id, e."from", e."to", t.depth + 1
      FROM edges e JOIN t ON e."from" = t."to"{bound}
    ) SELECT * FROM t"""


@pytest.mark.parametrize("name", ["ring", "diamond"])
@pytest.mark.parametrize("bound", ["", " WHERE t.depth < 3"])
def test_normalize_matches_reference_on_small_graphs(graphs, name, bound):
    """UNION ALL keeps dedup off on a non-forest and needs a bound there;
    the port says so as the reference does."""
    r, p = graphs[name]
    sql = UNION_ALL_RING.format(bound=bound)
    for s in (sql, directed(sql, "inbound"), directed(sql, "both"),
              ref.paper_listing(1, depth=2)):
        same_outcome(outcome(port.normalize, port.parse(s), p),
                     outcome(ref.normalize, ref.parse(s), r))


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def stat_roots(v: int) -> list:
    return [0, 1, 2, v // 2, v - 1, v, v + 5, -1, 3, 3]


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", ["golden"] + sorted(GRAPHS))
def test_stats_and_root_estimates_match_reference(golden, graphs, name,
                                                  direction):
    r, p = golden if name == "golden" else graphs[name]
    want = ref.compute_stats(r, direction)
    cached = direction in p.stats_cache
    calls = port.compute_stats.calls
    got = p.stats(direction)
    assert port.compute_stats.calls == calls + (not cached)
    assert p.stats(direction) is got              # cached per direction
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port.stats_digest(got) == ref.stats_digest(want)
    roots = stat_roots(p.num_vertices) + list(want.sample_roots)
    for depth in (0, 1, 3, 64):
        assert (port.root_estimates(p, direction, roots, depth)
                == ref.root_estimates(r, direction, roots, depth))
    assert port.root_estimates(p, direction, [], 4) == []


def test_stats_pass_runs_once_per_direction(graphs):
    _, p = graphs["ring"]
    p.stats_cache.clear()
    calls = port.compute_stats.calls
    for _ in range(3):
        p.stats("outbound")
    p.stats("both")
    assert port.compute_stats.calls == calls + 2
    assert not p.stats("outbound").is_forest


def test_stats_flags_match_reference_semantics(graphs):
    """The reference's own stats tests: a tree is a forest, a ring and a
    diamond are not."""
    assert not graphs["ring"][1].stats("outbound").is_forest
    assert not graphs["diamond"][1].stats("outbound").is_forest


# ---------------------------------------------------------------------------
# caps, buckets and the ranking
# ---------------------------------------------------------------------------

def logical_pair(r, p, sql, **kw):
    return (ref.normalize(ref.parse(sql), r, **kw),
            port.normalize(port.parse(sql), p, **kw))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_default_caps_and_buckets_match_reference(golden, graphs,
                                                  direction):
    r, p = golden
    for name in LISTINGS:
        if name in WEIGHTED and direction == "both":
            continue
        lr, lp = logical_pair(r, p, directed(LISTINGS[name](depth=7),
                                             direction))
        caps = ref.default_caps(r.stats(direction), lr)
        assert port.default_caps(p.stats(direction), lp) == caps
    # UNION ALL walks on a non-forest: the walk-profile branch
    gr, gp = graphs["multi5"]
    sql = directed(UNION_ALL_RING.format(bound=" WHERE t.depth < 4"),
                   direction)
    lr, lp = logical_pair(gr, gp, sql)
    assert not lr.dedup
    assert (port.default_caps(gp.stats(direction), lp)
            == ref.default_caps(gr.stats(direction), lr))
    roots = [0, 1, 2, 5, 17, 100, 2000, 2999, 0, 3000, -1, 7, 8, 9]
    for kw in (dict(max_depth=7, caps=caps),
               dict(max_depth=3, caps=caps, max_buckets=2),
               dict(max_depth=7, caps=caps, max_buckets=1),
               dict(max_depth=7, caps=caps, dedup=False)):
        for rs in (roots, roots[:1], []):
            got = port.bucket_roots(p, rs, direction=direction, **kw)
            want = ref.bucket_roots(r, np.asarray(rs), direction=direction,
                                    **kw)
            assert [as_dict(b) for b in got] == [as_dict(b) for b in want]


def same_report(got, want):
    assert [c.label for c in got.ranked] == [c.label for c in want.ranked]
    np.testing.assert_allclose([c.cost.est_us for c in got.ranked],
                               [c.cost.est_us for c in want.ranked],
                               rtol=1e-12, atol=0)
    assert got.skipped == want.skipped
    assert as_dict(got.logical) == as_dict(want.logical)
    assert got.constants == want.constants
    for g, w in zip(got.ranked, want.ranked):
        assert dataclasses.asdict(g.query) == dataclasses.asdict(w.query)
        assert g.use_kernel == w.use_kernel


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", sorted(LISTINGS))
def test_plan_ranks_as_reference(golden, name, direction, lanes):
    r, p = golden
    sql = directed(LISTINGS[name](depth=7), direction)
    same_report(port.plan(sql, p, lanes=lanes),
                ref.plan(sql, r, lanes=lanes))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", ["ring", "multi12"])
def test_plan_ranks_as_reference_on_small_graphs(graphs, name, direction):
    r, p = graphs[name]
    for sql in (UNION_ALL_RING.format(bound=" WHERE t.depth < 3"),
                ref.paper_listing(1, depth=3)):
        sql = directed(sql, direction)
        for lanes in (1, 8, 40):
            same_report(port.plan(sql, p, lanes=lanes),
                        ref.plan(sql, r, lanes=lanes))


@pytest.mark.parametrize("kf", KERNEL_FACTORS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_kernel_candidate_lands_in_the_same_rank(golden, direction, kf):
    """With a pinned kernel factor the ``precursive+kernel`` candidate is
    priced (or skipped) exactly as the reference does."""
    r, p = golden
    consts = (ref.CostConstants(kernel_factor=kf),
              port.CostConstants(kernel_factor=kf))
    for name in ("p1", "p3", "sum"):
        sql = directed(LISTINGS[name](depth=7), direction)
        want = ref.plan(sql, r, include_kernel=True, constants=consts[0])
        got = port.plan(sql, p, include_kernel=True, constants=consts[1])
        same_report(got, want)
        labels = [c.label for c in got.ranked]
        assert (port.KERNEL_LABEL in labels) == (
            direction != "both" and name != "sum")


def test_plan_with_other_constants_matches_reference(golden):
    r, p = golden
    kw = dict(bytes_per_us=777.0, level_us=3.0, base_us=9.0,
              pull_alpha=0.25, pull_beta=8.0)
    sql = ref.paper_listing(1, depth=7)
    want = ref.plan(sql, r, constants=ref.CostConstants(**kw))
    got = port.plan(sql, p, constants=port.CostConstants(**kw))
    same_report(got, want)
    for g, w in zip(got.ranked, want.ranked):
        assert g.pipeline.render() == w.pipeline.render()


def test_plan_errors_match_reference(golden, graphs):
    r, p = golden
    sql = ref.paper_listing(1, depth=3).replace(
        "SELECT * FROM t", "SELECT nosuch FROM t")
    same_outcome(outcome(port.plan, sql, p), outcome(ref.plan, sql, r))
    gr, gp = graphs["ring"]
    sql = UNION_ALL_RING.format(bound="")
    same_outcome(outcome(port.plan, sql, gp), outcome(ref.plan, sql, gr))


# ---------------------------------------------------------------------------
# plan_and_run
# ---------------------------------------------------------------------------

def assert_same_dressed(got, want):
    assert_same_result(got, want)
    if want.vertex_values is None:
        assert got.vertex_values is None
    else:
        np.testing.assert_array_equal(got.vertex_values.numpy(),
                                      np.asarray(want.vertex_values))


def assert_same_rows(got, want):
    """The live rows of a result at bucket caps against those of one at
    the plan's caps: count, depth, overflow and the first ``count`` entries
    of every column and of the positions and row depths."""
    n = int(want.count)
    assert int(got.count) == n
    assert int(got.depth) == int(want.depth)
    assert bool(got.overflow) == bool(want.overflow)
    assert torch.equal(got.positions[:n], want.positions[:n])
    assert torch.equal(got.row_depths[:n], want.row_depths[:n])
    assert sorted(got.values) == sorted(want.values)
    for k, v in want.values.items():
        assert torch.equal(got.values[k][:n], v[:n]), k


RUN_ROOTS = (0, [0, 1, 17, 2999])


@pytest.mark.parametrize("roots", RUN_ROOTS, ids=["root", "roots4"])
@pytest.mark.parametrize("name", sorted(LISTINGS))
def test_plan_and_run_matches_reference(golden, name, roots):
    r, p = golden
    sql = LISTINGS[name](depth=6)
    want = ref.plan_and_run(sql, r, roots)
    got = port.plan_and_run(sql, p, roots)
    assert sorted(got.values) == sorted(want.values)
    assert ("depth" in got.values) == (name != "p3")
    assert ("value" in got.values) == (name in WEIGHTED)
    assert_same_dressed(got, want)
    # the core re-export and the chosen engine by name give the same
    best = port.choose(sql, p)
    assert best.label == ref.choose(sql, r).label
    again = port_engine.plan_and_run(sql, p, roots)
    assert_same_dressed(again, got)


def test_literal_root_and_bucketed_run_match_reference(golden):
    r, p = golden
    sql = ref.paper_listing(1, root=17, depth=6)
    assert_same_dressed(port.plan_and_run(sql, p),
                        ref.plan_and_run(sql, r))
    roots = [0, 1, 17, 2999, 5, 0]
    best_r, best_p = ref.choose(sql, r), port.choose(sql, p)
    got = best_p.run_bucketed(p, roots)
    want = best_r.run_bucketed(r, roots)
    assert len(got) == len(want) == len(roots)
    for root, g, w in zip(roots, got, want):
        assert_same_dressed(g, w)
        assert_same_rows(g, best_p.run(p, root))
    with pytest.raises(ValueError, match="VECTOR"):
        best_p.run_bucketed(p, 3)
    q = port.plan(PARSE_CASES["param-root"], p).best
    with pytest.raises(ValueError, match="no root"):
        q.run(p)
