"""Persistent plan store: serialize a :class:`~repro_torch.planner.
serving.ServingSession`'s cache grains + calibration state to one JSON file
and rehydrate them in a cold process.

Everything flows through the machine-readable plan schema
(:func:`repro_torch.planner.explain.to_json`, ``schema_version`` 6): a
cached :class:`PlannerReport` serializes as exactly the document ``explain_json``
would emit, and a :class:`PlanEntry` serializes as its cached ``plan_json``
plus the per-bucket physical choices.  Rehydration rebuilds live planner
objects WITHOUT re-planning:

* graph statistics come back from the stored stats section (seeding
  ``Dataset.stats_cache`` — no sampled traversals re-run);
* pipelines are rebuilt from engine names through the same
  ``build_plan`` the planner uses (building is cheap and deterministic;
  costing — the expensive, statistics-dependent part — is restored from
  the stored numbers, never recomputed);
* the calibrator resumes from its serialized normal equations, so the
  refit constants survive the process boundary.

A ``ServingSession(ds, plan_store=path)`` that finds ``path`` answers its
first request for known traffic with ZERO parse / statistics / costing
passes (``session.counters``); only the first-use costs of a process (the
kernels' first load, the caching allocator) are paid.

The store's format is the JAX reference's: ``graph_digest`` hashes the
same int64 bytes, so a store written by either package loads in the other.
Measured kernel factors are keyed ``"<device type>/<kernel>"`` (``cuda`` or
``cpu``) where the reference keys them on its JAX backend; a pre-v3 store's
un-keyed factor lands in the cell of the session dataset's device type.

**Schema migration:** version-1 documents still load —
:func:`migrate_plan_doc` fills the v2-only fields with conservative
defaults (empty profile tails, ``plain_bytes == total_bytes`` /
``kernel_bytes == 0`` — i.e. a v1 kernel candidate's statically-factored
bytes are folded into the plain term, accurate for everything the v1
writer could rank).  Documents are written atomically (temp file +
``os.replace``).
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import tempfile

import torch

from ..core.engine import Dataset, RecursiveQuery, build_plan
from ..core.operators import EngineCaps
from ..core.recursive import precursive_plan
from ..obs import faultinject as _fault

from . import calibrate as _calibrate
from .ast import LogicalQuery
from .calibrate import Calibrator, kernel_expand_fn
from .cost import CostConstants, DEFAULT_CONSTANTS, OpEstimate, PlanCost
from .explain import PLAN_SCHEMA_VERSION
from .optimize import PhysicalChoice, PlannerReport, RootBucket
from .serving import PlanEntry, ServingSession, shape_key
from .stats import GraphStats

__all__ = ["graph_digest", "load_store", "logical_from_json",
           "logical_to_json", "migrate_plan_doc", "rehydrate_into",
           "rehydrate_session", "report_from_json", "save_session",
           "stats_from_json", "stats_to_json"]

STORE_KIND = "plan_store"


# ---------------------------------------------------------------------------
# leaf (de)serializers — inverses of the to_json sections
# ---------------------------------------------------------------------------

def graph_digest(ds: Dataset) -> str:
    """Digest of the actual edge list: a store written against one graph
    must refuse to warm a session over a different one.  Each join column
    comes to the host once, as int64: the same bytes, and so the same
    digest, as the reference's for the same graph."""
    h = hashlib.sha1()
    h.update(str(int(ds.num_vertices)).encode())
    for name in ("from", "to"):
        col = ds.table.column(name).to("cpu", torch.int64)
        h.update(col.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def logical_to_json(lg: LogicalQuery) -> dict:
    return {
        "root": lg.root,
        "max_depth": lg.max_depth,
        "payload_cols": lg.payload_cols,
        "dedup": lg.dedup,
        "direction": lg.direction,
        "want_cols": list(lg.want_cols),
        "want_depth": lg.want_depth,
        "union_all": lg.union_all,
        "workload": getattr(lg, "workload", "reach"),
        "weight_col": getattr(lg, "weight_col", None),
    }


def logical_from_json(doc: dict) -> LogicalQuery:
    wc = doc.get("weight_col")
    return LogicalQuery(
        root=(None if doc["root"] is None else int(doc["root"])),
        max_depth=int(doc["max_depth"]),
        payload_cols=int(doc["payload_cols"]),
        dedup=bool(doc["dedup"]),
        direction=str(doc["direction"]),
        want_cols=tuple(str(c) for c in doc["want_cols"]),
        want_depth=bool(doc["want_depth"]),
        union_all=bool(doc["union_all"]),
        workload=str(doc.get("workload", "reach")),
        weight_col=(None if wc is None else str(wc)))


def stats_to_json(st: GraphStats) -> dict:
    return {
        "direction": st.direction,
        "num_vertices": st.num_vertices,
        "num_edges": st.num_edges,
        "density": st.density,
        "avg_degree": st.avg_degree,
        "max_degree": st.max_degree,
        "is_forest": st.is_forest,
        "sample_roots": list(st.sample_roots),
        "level_edges": list(st.level_edges),
        "max_levels": st.max_levels,
        "reach_edges": st.reach_edges,
        "degree_histogram": list(st.degree_histogram),
        "level_vertices": list(st.level_vertices),
        "max_level_edges": st.max_level_edges,
        "root_profiles": [[r, list(p)] for r, p in st.root_profiles],
        "level_walk_edges": list(st.level_walk_edges),
    }


def stats_from_json(doc: dict) -> GraphStats:
    level_edges = tuple(float(x) for x in doc["level_edges"])
    return GraphStats(
        direction=str(doc["direction"]),
        num_vertices=int(doc["num_vertices"]),
        num_edges=int(doc["num_edges"]),
        density=float(doc["density"]),
        avg_degree=float(doc["avg_degree"]),
        max_degree=int(doc["max_degree"]),
        degree_histogram=tuple(int(x)
                               for x in doc.get("degree_histogram", [])),
        is_forest=bool(doc["is_forest"]),
        sample_roots=tuple(int(r) for r in doc["sample_roots"]),
        level_edges=level_edges,
        level_vertices=tuple(float(x)
                             for x in doc.get("level_vertices", [])),
        max_level_edges=int(doc.get("max_level_edges",
                                    max(level_edges, default=0))),
        reach_edges=float(doc["reach_edges"]),
        max_levels=int(doc["max_levels"]),
        root_profiles=tuple(
            (int(r), tuple(int(x) for x in p))
            for r, p in doc.get("root_profiles", [])),
        level_walk_edges=tuple(float(x)
                               for x in doc.get("level_walk_edges", [])))


# ---------------------------------------------------------------------------
# schema migration: v1 plan documents load under the v2 reader
# ---------------------------------------------------------------------------

def migrate_plan_doc(doc: dict) -> dict:
    """Upgrade one machine-readable plan document to ``schema_version`` 6
    (a copy; the input is not mutated).  v6 documents pass through.

    v1 -> v2: fill the rehydration-only stats fields and fold the v1
    writer's statically-factored kernel bytes into ``plain_bytes``.
    v2 -> v3: candidates gain ``level_dirs: []`` (a v2 writer knew no
    direction-optimizing engines, so every stored plan is push-only) and
    the cost constants gain the default ``pull_alpha``/``pull_beta``
    thresholds (:meth:`CostConstants.from_json` defaults them).
    v3 -> v4: the document gains the top-level ``analyze`` section
    (``null`` — an older writer never reconciled predicted vs. actual).
    v4 -> v5: the logical section gains ``workload='reach'`` /
    ``weight_col=null`` and every candidate gains ``semiring='reach'`` —
    an older writer only ever planned boolean BFS.
    v5 -> v6: the document gains the top-level ``admission`` section
    (``null`` — a pre-guard writer never guarded a request) and the cost
    constants gain the default guard budgets
    (:meth:`CostConstants.from_json` defaults them)."""
    v = doc.get("schema_version")
    if v == PLAN_SCHEMA_VERSION:
        return doc
    if v not in (1, 2, 3, 4, 5):
        raise ValueError(f"unsupported plan schema_version {v!r} "
                         f"(this reader handles 1..{PLAN_SCHEMA_VERSION})")
    out = copy.deepcopy(doc)
    out["schema_version"] = PLAN_SCHEMA_VERSION
    st = out.get("stats", {})
    if v == 1:
        st.setdefault("degree_histogram", [])
        st.setdefault("level_vertices",
                      [0.0] * len(st.get("level_edges", [])))
        st.setdefault("max_level_edges",
                      int(max(st.get("level_edges", []), default=0)))
        st.setdefault("root_profiles", [])
        st.setdefault("level_walk_edges", [])
    out.setdefault("cost_constants", DEFAULT_CONSTANTS.to_json())
    lg = out.get("logical", {})
    lg.setdefault("workload", "reach")           # v<=4: boolean BFS only
    lg.setdefault("weight_col", None)
    for c in out.get("candidates", []):
        cost = c.get("cost", {})
        # a v1 writer folded any (static) kernel factor into total_bytes;
        # migrating it as plain keeps every v1 ranking reproducible
        cost.setdefault("plain_bytes", cost.get("total_bytes", 0.0))
        cost.setdefault("kernel_bytes", 0.0)
        cost.setdefault("level_dirs", [])        # v<=2: push-only plans
        c.setdefault("semiring", "reach")        # v<=4: no value plane
    out.setdefault("analyze", None)              # v<=3: never analyzed
    out.setdefault("admission", None)            # v<=5: never guarded
    return out


# ---------------------------------------------------------------------------
# rebuilding live planner objects (build yes, cost no)
# ---------------------------------------------------------------------------

def _choice_from_json(cj: dict, logical: LogicalQuery) -> PhysicalChoice:
    """Rebuild one PhysicalChoice: RecursiveQuery from the logical axes,
    Pipeline rebuilt through ``build_plan`` (the planner's own builder —
    bit-identical execution; the kernel candidate takes the
    ``frontier_expand`` wrapper), PlanCost restored verbatim."""
    caps = EngineCaps(frontier=int(cj["caps"]["frontier"]),
                      result=int(cj["caps"]["result"]))
    engine = str(cj["engine"])
    use_kernel = bool(cj.get("use_kernel", False))
    q = RecursiveQuery(engine=engine, max_depth=logical.max_depth,
                       payload_cols=logical.payload_cols, caps=caps,
                       dedup=logical.dedup, direction=logical.direction,
                       workload=getattr(logical, "workload", "reach"),
                       weight_col=getattr(logical, "weight_col", None),
                       lanes=int(cj.get("lanes", 1)))
    if use_kernel:
        pipeline = precursive_plan(caps, q.max_depth, q.out_cols, q.dedup,
                                   q.direction, expand_fn=kernel_expand_fn())
    else:
        # build_plan routes weighted workloads to the semiring pipelines
        # and reach through the engine builders, as plan() does
        pipeline = build_plan(q)
    cost = cj["cost"]
    plan_cost = PlanCost(
        total_bytes=float(cost["total_bytes"]),
        est_us=float(cost["est_us"]),
        levels=int(cost["levels"]),
        result_rows=float(cost["result_rows"]),
        per_op=tuple(OpEstimate(str(o["label"]), float(o["rows"]),
                                float(o["bytes"])) for o in cj["ops"]),
        plain_bytes=float(cost["plain_bytes"]),
        kernel_bytes=float(cost["kernel_bytes"]),
        level_dirs=tuple(str(d) for d in cost.get("level_dirs", [])))
    return PhysicalChoice(engine=engine, query=q, logical=logical,
                          pipeline=pipeline, cost=plan_cost,
                          use_kernel=use_kernel)


def report_from_json(doc: dict) -> PlannerReport:
    """Rebuild a full PlannerReport from a (v1 to v6) plan document."""
    doc = migrate_plan_doc(doc)
    logical = logical_from_json(doc["logical"])
    stats = stats_from_json(doc["stats"])
    ranked = tuple(_choice_from_json(cj, logical)
                   for cj in doc["candidates"])
    skipped = tuple((str(s["engine"]), str(s["reason"]))
                    for s in doc.get("skipped", []))
    constants = CostConstants.from_json(
        doc.get("cost_constants", DEFAULT_CONSTANTS.to_json()))
    return PlannerReport(logical=logical, stats=stats, ranked=ranked,
                         skipped=skipped, constants=constants)


def _buckets_from_json(bdocs) -> tuple:
    return tuple(RootBucket(
        indices=tuple(int(i) for i in b["lanes"]),
        roots=tuple(int(r) for r in b["roots"]),
        caps=EngineCaps(frontier=int(b["caps"]["frontier"]),
                        result=int(b["caps"]["result"])),
        predicted_reach=float(b["predicted_reach"]),
        predicted_depth=int(b["predicted_depth"])) for b in bdocs)


# ---------------------------------------------------------------------------
# whole-session save / rehydrate
# ---------------------------------------------------------------------------

def _choice_json(c: PhysicalChoice) -> dict:
    """The candidate schema of explain.to_json, minus the rank flags (a
    bucket choice is not ranked inside an entry)."""
    return {
        "label": c.label,
        "engine": c.engine,
        "use_kernel": c.use_kernel,
        "semiring": getattr(c.pipeline, "semiring", "reach"),
        "lanes": getattr(c.query, "lanes", 1),
        "caps": {"frontier": c.query.caps.frontier,
                 "result": c.query.caps.result},
        "cost": {"est_us": c.cost.est_us,
                 "total_bytes": c.cost.total_bytes,
                 "levels": c.cost.levels,
                 "result_rows": c.cost.result_rows,
                 "plain_bytes": c.cost.plain_bytes,
                 "kernel_bytes": c.cost.kernel_bytes,
                 "level_dirs": list(c.cost.level_dirs)},
        "ops": [{"label": op.label, "rows": op.rows, "bytes": op.bytes}
                for op in c.cost.per_op],
    }


def session_to_json(session: ServingSession) -> dict:
    """The full store document for one session (plain ``json.dumps``-able)."""
    ds = session.ds
    from .explain import to_json
    stats_cache = ds.stats_cache or {}
    return {
        "schema_version": PLAN_SCHEMA_VERSION,
        "kind": STORE_KIND,
        "graph": {"num_vertices": int(ds.num_vertices),
                  "num_edges": int(ds.table.num_rows),
                  "digest": graph_digest(ds)},
        "calibration": session.calibrator.state_dict(),
        "kernel_factors_measured": _calibrate.measured_factors_state(),
        "stats": {d: stats_to_json(st) for d, st in stats_cache.items()},
        "logical": {sql: logical_to_json(lg)
                    for sql, lg in session._logical.items()},
        "shapes": [to_json(report) for report in session._choice.values()],
        "entries": [{
            "roots": list(entry.roots),
            "signature": [list(s) for s in entry.bucket_signature],
            "hits": entry.hits,
            "bucket_choices": [_choice_json(c)
                               for c in entry.bucket_choices],
            "plan_json": entry.plan_json,
        } for entry in session._plans.values()],
    }


def save_session(session: ServingSession, path: str) -> str:
    """Atomically write the session's plan store to ``path``."""
    doc = session_to_json(session)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".plan_store.", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_store(path: str) -> dict:
    """Read + schema-migrate a plan-store file."""
    with open(path) as f:
        text = f.read()
    if _fault._ACTIVE and _fault.consume("plan_store_corrupt"):
        # chaos seam: serve the reader a truncated byte stream, as if the
        # writer had died mid-write without the atomic-rename protection
        text = text[:len(text) // 2]
    doc = json.loads(text)
    if doc.get("kind") != STORE_KIND:
        raise ValueError(f"{path} is not a plan store "
                         f"(kind={doc.get('kind')!r})")
    v = doc.get("schema_version")
    if v not in (1, 2, 3, 4, 5, PLAN_SCHEMA_VERSION):
        raise ValueError(f"unsupported plan-store schema_version {v!r}")
    doc = dict(doc)
    doc["schema_version"] = PLAN_SCHEMA_VERSION
    doc["shapes"] = [migrate_plan_doc(s) for s in doc.get("shapes", [])]
    for e in doc.get("entries", []):
        e["plan_json"] = migrate_plan_doc(e["plan_json"])
        for c in e.get("bucket_choices", []):
            cost = c.get("cost", {})
            cost.setdefault("plain_bytes", cost.get("total_bytes", 0.0))
            cost.setdefault("kernel_bytes", 0.0)
            cost.setdefault("level_dirs", [])
    return doc


def rehydrate_into(session: ServingSession, path: str) -> None:
    """Warm ``session`` from a plan-store file: graph statistics, logical /
    choice / bucket-choice / plan caches, the exact-request memo, and the
    calibration state.  The graph digest must match the session's dataset.

    After this, a request for stored traffic performs NO parse, NO
    statistics pass and NO costing (``session.counters`` stay zero)."""
    ds = session.ds
    doc = load_store(path)
    g = doc["graph"]
    digest = graph_digest(ds)
    if (int(g["num_vertices"]) != int(ds.num_vertices)
            or g["digest"] != digest):
        raise ValueError(
            f"plan store {path} was written for a different graph "
            f"(store: V={g['num_vertices']} digest={g['digest']}; "
            f"dataset: V={ds.num_vertices} digest={digest})")

    # graph statistics: seed the Dataset's stats cache (same slot
    # Dataset.stats() fills) so NOTHING recomputes them
    cache = ds.stats_cache
    for direction, st in doc.get("stats", {}).items():
        cache.setdefault(direction, stats_from_json(st))

    # resume the calibration state — unless the caller supplied a
    # configured calibrator (custom prior or already-observed traffic), in
    # which case the caller's configuration wins over the stored state
    cal = session.calibrator
    pristine = (cal.count == 0 and cal.prior == DEFAULT_CONSTANTS
                and cal.constants == cal.prior)
    if pristine:
        session.calibrator = Calibrator.from_state(doc["calibration"])
    if doc.get("kernel_factors_measured"):
        _calibrate.restore_measured_factors(doc["kernel_factors_measured"])
    if doc.get("kernel_factor_measured") is not None:
        # pre-v3 stores held ONE un-keyed factor, for the frontier_expand
        # kernel; it fills the cell of this dataset's device type.  Same
        # policy as restore_measured_factors: this process's own
        # measurement is fresher than the store's — only fill a missing
        # cell, never clobber one
        _calibrate.restore_measured_factors(
            {f"{ds.device.type}/frontier_expand":
             float(doc["kernel_factor_measured"])})

    for sql, lg in doc.get("logical", {}).items():
        session._logical[sql] = logical_from_json(lg)
    for rep_doc in doc.get("shapes", []):
        report = report_from_json(rep_doc)
        session._choice[shape_key(report.logical)] = report

    for e in doc.get("entries", []):
        pj = e["plan_json"]
        report = report_from_json(pj)
        logical = report.logical
        buckets = _buckets_from_json(pj.get("buckets", []))
        choices = tuple(_choice_from_json(cj, logical)
                        for cj in e["bucket_choices"])
        signature = tuple(b.signature for b in buckets)
        entry = PlanEntry(
            choice=report.best, report=report,
            roots=tuple(int(r) for r in e["roots"]), buckets=buckets,
            bucket_choices=choices, bucket_signature=signature,
            plan_json=pj, hits=int(e.get("hits", 0)), served=0)
        key = (shape_key(logical), signature)
        session._plans[key] = entry
        session._requests[(shape_key(logical), entry.roots)] = key
        for b, c in zip(buckets, choices):
            session._bucket_plans.setdefault(
                (shape_key(logical), b.caps, len(b.roots)), c)


def rehydrate_session(ds: Dataset, path: str,
                      **session_kwargs) -> ServingSession:
    """Build a ServingSession warmed from a plan-store file."""
    session = ServingSession(ds, **session_kwargs)
    session.plan_store_path = path
    if not session._plans:          # plan_store kwarg may have loaded it
        rehydrate_into(session, path)
    return session
