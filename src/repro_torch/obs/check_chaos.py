"""Chaos smoke: one injected fault per class through the serving front
door, on a small graph, in one process (the port's copy of the repo's
``scripts/check_chaos.py``, with the same fault classes).

Arm each :mod:`repro_torch.obs.faultinject` point once (plus the two
no-seam fault classes: garbage roots and an over-budget root), drive a
request through a :class:`~repro_torch.planner.ServingSession` on the
chosen device, and print one PASS/FAIL line per class.  Exit 1 if any
class fails: a fault must end in a classified degraded answer or a typed
error, never a crash, a hang, or silently-wrong rows.

Usage: ``python -m repro_torch.obs.check_chaos [--device cpu]`` (default:
the card; no card raises).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import warnings

import numpy as np

CLASSES = ("bucket_overflow", "straggler_deadline", "plan_store_corrupt",
           "calibrator_poison", "garbage_requests")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the dataset (default: the card)")
    args = ap.parse_args(argv)

    from ..convert import dataset_from_numpy
    from ..data.treegen import TreeSpec, make_edge_table
    from ..planner import ServingSession, paper_listing
    from ..planner.calibrate import Calibrator
    from ..planner.cost import DEFAULT_CONSTANTS
    from ..planner.guards import AdmissionError, InvalidRequestError
    from ..planner.plan_store import save_session
    from . import faultinject

    spec = TreeSpec(num_vertices=2000, height=8, payload_cols=0, seed=7)
    ds = dataset_from_numpy(make_edge_table(spec), spec.num_vertices,
                            args.device)
    sql = paper_listing(1, root=0, depth=4)
    roots = [0, 1, 7, 500]

    def ids(r) -> list:
        return sorted(np.asarray(r.values["id"])[:int(r.count)].tolist())

    baseline_session = ServingSession(ds)
    base_ids = [ids(r) for r in baseline_session.submit(sql, roots)]

    def parity(out, skip=()) -> bool:
        return all(ids(got) == want
                   for r, got, want in zip(roots, out, base_ids)
                   if r not in skip)

    results = []

    def check(name, fn):
        try:
            ok, detail = fn()
        except Exception as e:                     # a crash IS the failure
            ok, detail = False, f"crashed: {type(e).__name__}: {e}"
        results.append((name, ok, detail))
        print(f"{'PASS' if ok else 'FAIL'} chaos/{name}: {detail}")

    def overflow():
        s = ServingSession(ds)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with faultinject.injected("bucket_overflow"):
                out = s.submit(sql, roots)
        rep = s.last_report
        return (rep.retries >= 1 and parity(out),
                f"retries={rep.retries}, rows match baseline")

    def straggler():
        s = ServingSession(ds)
        s.submit(sql, roots)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with faultinject.injected("straggler_sleep", 0.05, times=None):
                out = s.submit(sql, roots, deadline_us=20_000.0)
        rep = s.last_report
        return (rep.truncated and parity(out, skip=set(rep.skipped_roots)),
                f"truncated, skipped_roots={rep.skipped_roots}")

    def corrupt_store():
        with tempfile.TemporaryDirectory(prefix="chaos_store.") as d:
            path = os.path.join(d, "store.json")
            save_session(baseline_session, path)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                with faultinject.injected("plan_store_corrupt"):
                    s = ServingSession(ds, plan_store=path)
        warned = any("cold-start" in str(x.message) for x in w)
        out = s.submit(sql, roots)
        return (warned and parity(out),
                "warned + cold-started + serves row-parity answers")

    def poison():
        s = ServingSession(ds, calibrate_every=4)
        s.submit(sql, roots)         # cold: plan + compile, no observation
        with faultinject.injected("calibrator_poison", float("nan"),
                                  times=None):
            out = s.submit(sql, roots)
        c = s.calibrator.constants
        finite = all(v is None or math.isfinite(v)
                     for v in (c.base_us, c.level_us, c.bytes_per_us,
                               c.kernel_factor))
        return (s.calibrator.discarded > 0 and finite and parity(out),
                f"discarded={s.calibrator.discarded}, constants finite")

    def garbage():
        s = ServingSession(ds)
        typed = 0
        for bad in ([-1], [ds.num_vertices + 5], [0.25]):
            try:
                s.submit(sql, bad)
            except InvalidRequestError:
                typed += 1
        tight = DEFAULT_CONSTANTS._replace(guard_degrade_us=1e-6,
                                           guard_reject_us=1e-3)
        s2 = ServingSession(ds, calibrator=Calibrator(prior=tight))
        try:
            s2.submit(sql, [0])
        except AdmissionError:
            typed += 1
        out = s.submit(sql, roots)                 # the session survives
        return (typed == 4 and parity(out),
                f"{typed}/4 typed errors, session still serves")

    for name, fn in zip(CLASSES, (overflow, straggler, corrupt_store,
                                  poison, garbage)):
        check(name, fn)

    if faultinject.armed():
        print("FAIL chaos/seam: a fault is still armed after the sweep")
        return 1
    failed = [n for n, ok, _ in results if not ok]
    if failed:
        print(f"CHAOS SMOKE FAILED: {failed}")
        return 1
    print(f"chaos smoke OK: {len(results)} fault class(es) on "
          f"{ds.device.type}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
