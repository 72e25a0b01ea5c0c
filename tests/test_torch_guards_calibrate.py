"""The port's admission guards and calibration (``repro_torch.planner.
guards`` and ``.calibrate``) against the JAX reference's.

Tolerances: guard decisions, their prices, clamps and messages, and plan
signatures exactly equal (the same float arithmetic in the same order);
the calibrator's refits within a relative 1e-9 (the same numpy least
squares), its serialized state equal after a JSON round trip.  The
measured kernel factors are the port's own (each package times its own
kernels): only their caching, keys and refusals are held here.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import Dataset
from repro.data.treegen import TreeSpec, make_edge_table
from repro.planner import calibrate as ref_cal
from repro.planner import guards as ref_guards
from repro.planner import stats as ref_stats
from repro.planner.cost import CostConstants as RefConstants
from repro_torch.convert import dataset_from_numpy
from repro_torch.core.engine import EngineCaps
from repro_torch.planner import calibrate as port_cal
from repro_torch.planner import guards as port_guards
from repro_torch.planner import stats as port_stats
from repro_torch.planner.cost import CostConstants as PortConstants
from test_torch_engine import DIRECTIONS
from test_torch_engine import release_reference_executables  # noqa: F401

TREE = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
BUDGETS = ((1e6, 1e7), (60.0, 80.0), (60.0, 1e9), (75.0, 75.0), (1.0, 2.0),
           (5e3, 1e4), (1e9, 1.0))
ROOTS = [0, 1, 2, 5, 17, 100, 2000, 2999, -1, 3000, 0]


@pytest.fixture(scope="module")
def tree():
    r = Dataset.prepare(make_edge_table(TREE), TREE.num_vertices)
    carried = {k: np.asarray(v) for k, v in r.table.columns.items()}
    return r, dataset_from_numpy(carried, TREE.num_vertices, "cpu")


def consts(module_constants, degrade, reject, **kw):
    return module_constants(guard_degrade_us=float(degrade),
                            guard_reject_us=float(reject), **kw)


def estimates(seed: int = 0, n: int = 40):
    """Seeded root estimates: exact and not, zero-depth and deep, reaches
    from nothing to 10^9 rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        depth = int(rng.integers(0, 40))
        reach = float(10.0 ** rng.uniform(-1, 9)) if i % 5 else 0.0
        out.append((i, reach, float(reach * rng.uniform(0, 1)), depth,
                    bool(i % 3 == 0)))
    return out


ESTIMATES = estimates()


@pytest.mark.parametrize("degrade,reject", BUDGETS)
def test_decide_and_guard_cost_match_reference(degrade, reject):
    rc = consts(RefConstants, degrade, reject)
    pc = consts(PortConstants, degrade, reject)
    for fields in ESTIMATES:
        re_, pe = ref_stats.RootEstimate(*fields), \
            port_stats.RootEstimate(*fields)
        for depth in (None, 0, 1, 3, 100):
            assert (port_guards.guard_cost_us(pe, pc, depth=depth)
                    == ref_guards.guard_cost_us(re_, rc, depth=depth))
        for md in (1, 4, 16):
            for row_bytes in (8.0, 188.0):
                want = ref_guards.decide(re_, rc, max_depth=md,
                                         row_bytes=row_bytes)
                got = port_guards.decide(pe, pc, max_depth=md,
                                         row_bytes=row_bytes)
                assert tuple(got) == tuple(want)
                assert got.to_json() == want.to_json()
                if got.decision == "reject":
                    assert (str(port_guards.AdmissionError(got))
                            == str(ref_guards.AdmissionError(want)))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("degrade,reject", BUDGETS)
def test_admit_roots_matches_reference(tree, direction, degrade, reject):
    r, p = tree
    rc = consts(RefConstants, degrade, reject, bytes_per_us=50.0)
    pc = consts(PortConstants, degrade, reject, bytes_per_us=50.0)
    for md in (1, 7):
        want = ref_guards.admit_roots(r, direction, ROOTS, md, rc)
        got = port_guards.admit_roots(p, direction, ROOTS, md, pc)
        assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert port_guards.admit_roots(p, direction, [], 7, pc) == []


def test_error_types_keep_their_bases():
    assert issubclass(port_guards.InvalidRequestError, ValueError)
    assert issubclass(port_guards.AdmissionError, RuntimeError)
    assert port_guards.GUARD_ROW_BYTES == ref_guards.GUARD_ROW_BYTES


# ---------------------------------------------------------------------------
# the calibrator
# ---------------------------------------------------------------------------

def observations(seed: int, n: int = 48, kernel_share: float = 0.25,
                 noise: float = 0.02):
    """Latencies generated by the cost formula at diverse shapes, with
    seeded noise (tests/test_calibrate.py's generator)."""
    rng = np.random.default_rng(seed)
    true = dict(bytes_per_us=2000.0, level_us=120.0, base_us=400.0,
                kernel_factor=8.0)
    out = []
    for i in range(n):
        levels = int(rng.integers(1, 8))
        plain = float(10.0 ** rng.uniform(4, 7))
        kernel = (float(10.0 ** rng.uniform(4, 6))
                  if rng.random() < kernel_share else 0.0)
        us = (true["base_us"] + true["level_us"] * levels
              + (plain + true["kernel_factor"] * kernel)
              / true["bytes_per_us"])
        us *= 1.0 + noise * rng.standard_normal()
        out.append((("sig", i % 11), levels, plain, kernel, max(us, 1.0)))
    out.append((("bad", 0), 1, 1.0, 0.0, float("nan")))      # discarded
    out.append((("bad", 1), 1, 1.0, 0.0, -5.0))
    return out


def feed(cal, obs):
    for sig, levels, plain, kernel, us in obs:
        cal.observe(sig, levels=levels, plain_bytes=plain,
                    kernel_bytes=kernel, measured_us=us)


def same_constants(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0), (g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kernel_share", [0.0, 0.25])
def test_calibrator_refits_as_reference(seed, kernel_share):
    rc, pc = ref_cal.Calibrator(), port_cal.Calibrator()
    obs = observations(seed, kernel_share=kernel_share)
    for part in (obs[:5], obs[5:30], obs[30:]):
        feed(rc, part)
        feed(pc, part)
        same_constants(pc.refit(), rc.refit())
        for f in ("count", "kernel_count", "refits", "rejected_refits",
                  "discarded"):
            assert getattr(pc, f) == getattr(rc, f), f
    assert pc.refits >= 1


def test_calibrator_rejects_garbage_as_reference():
    rc, pc = ref_cal.Calibrator(), port_cal.Calibrator()
    rng = np.random.default_rng(1)
    for i in range(24):
        plain = float(10.0 ** rng.uniform(4, 7))
        for cal in (rc, pc):
            cal.observe(("g", i), levels=4, plain_bytes=plain,
                        kernel_bytes=0.0,
                        measured_us=20_000.0 / (1.0 + plain / 1e5))
    assert tuple(pc.refit()) == tuple(rc.refit())
    assert pc.rejected_refits == rc.rejected_refits == 1


def test_calibrator_names_why_it_rejected():
    """``last_rejection`` says which adoption rule a rejected candidate
    failed, and is None after an adopted refit; the rule is the
    reference's (same refits and rejections)."""
    cal = port_cal.Calibrator()
    assert cal.last_rejection is None
    for i in range(3):
        cal.observe(("few", i), levels=4, plain_bytes=1e5, kernel_bytes=0.0,
                    measured_us=100.0)
    cal.observe(("few", 0), levels=4, plain_bytes=1e5, kernel_bytes=0.0,
                measured_us=100.0)
    cal.min_signatures = 4
    cal.min_observations = 4
    cal.refit()
    assert cal.last_rejection == "3 plan signatures observed, 4 needed"
    rng = np.random.default_rng(1)
    garbage = port_cal.Calibrator()
    for i in range(24):
        plain = float(10.0 ** rng.uniform(4, 7))
        garbage.observe(("g", i), levels=4, plain_bytes=plain,
                        kernel_bytes=0.0,
                        measured_us=20_000.0 / (1.0 + plain / 1e5))
    garbage.refit()
    assert garbage.rejected_refits == 1
    assert "must be lower" in garbage.last_rejection
    assert "Kendall tau" in garbage.last_rejection
    good = port_cal.Calibrator()
    feed(good, observations(0))
    good.refit()
    assert good.refits == 1 and good.last_rejection is None


def test_reference_state_carries_across_as_json():
    """A reference calibrator's ``state_dict()`` and its constants'
    ``to_json()``, written as JSON, load in the port and go on refitting
    as the reference does."""
    prior = RefConstants(bytes_per_us=5000.0, level_us=60.0, base_us=100.0,
                         kernel_factor=2.0, pull_alpha=0.5)
    rc = ref_cal.Calibrator(prior, min_observations=6, ridge=0.5,
                            max_log=16)
    obs = observations(7, n=40)
    feed(rc, obs[:20])
    rc.refit()
    state = json.loads(json.dumps(rc.state_dict()))
    pc = port_cal.Calibrator.from_state(state)
    assert json.loads(json.dumps(pc.state_dict())) == state
    doc = json.loads(json.dumps(rc.constants.to_json()))
    assert tuple(PortConstants.from_json(doc)) == tuple(rc.constants)
    feed(rc, obs[20:])
    feed(pc, obs[20:])
    same_constants(pc.refit(), rc.refit())
    assert pc.state_dict()["log"] == json.loads(json.dumps(
        rc.state_dict()["log"]))
    assert [tuple(o) for o in pc.log] == [tuple(o) for o in rc.log]


def test_plan_signature_and_kendall_tau_match_reference(tree):
    r, p = tree
    caps = EngineCaps(64, 128)
    for d in DIRECTIONS:
        digest = port_cal.stats_digest(p.stats(d))
        assert digest == ref_cal.stats_digest(r.stats(d))
        for kw in (dict(), dict(lanes=8, shape=(7, 2, True),
                                mix=("push", "pull"),
                                workload="aggregate_sum")):
            assert (port_cal.plan_signature("diropt", d, caps, digest, **kw)
                    == ref_cal.plan_signature("diropt", d, caps, digest,
                                              **kw))
    rng = np.random.default_rng(4)
    for n in (0, 1, 2, 9):
        a, b = rng.random(n).tolist(), rng.random(n).tolist()
        b[: n // 2] = a[: n // 2]
        assert port_cal._kendall_tau(a, b) == ref_cal._kendall_tau(a, b)


# ---------------------------------------------------------------------------
# the measured kernel factors
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_factors(monkeypatch):
    monkeypatch.setattr(port_cal, "_MEASURED_KERNEL_FACTORS", {})
    return port_cal._MEASURED_KERNEL_FACTORS


@pytest.mark.parametrize("kernel", port_cal.KERNEL_NAMES)
def test_measured_kernel_factor_on_cpu_is_cached(fresh_factors, monkeypatch,
                                                 kernel):
    """Measured once on the CPU (the kernel route there is the kernel's
    plain version), cached under ("cpu", kernel), then served from the
    cache without measuring again."""
    name = {"frontier_expand": "_measure_expand_factor",
            "frontier_pull": "_measure_pull_factor",
            "spmm_segment": "_measure_spmm_factor"}[kernel]
    measure, times = getattr(port_cal, name), []

    def recorded(device):
        times.append(measure(device))
        return times[-1]
    monkeypatch.setattr(port_cal, name, recorded)
    got = port_cal.measured_kernel_factor(kernel=kernel, device="cpu")
    assert 1e-3 <= got <= 1e6
    assert fresh_factors == {("cpu", kernel): got}
    [(t_kern, t_plain)] = times
    assert got == float(np.clip(t_kern / t_plain, 1e-3, 1e6))

    def again(device):
        raise AssertionError("measured twice")
    monkeypatch.setattr(port_cal, name, again)
    assert port_cal.measured_kernel_factor(kernel=kernel, device="cpu") \
        == got
    with pytest.raises(AssertionError, match="twice"):
        port_cal.measured_kernel_factor(kernel=kernel, device="cpu",
                                        refresh=True)


def test_measured_kernel_factor_keys_and_refusals(fresh_factors,
                                                  monkeypatch):
    with pytest.raises(ValueError, match="unknown kernel"):
        port_cal.measured_kernel_factor(kernel="nope", device="cpu")
    port_cal.set_measured_kernel_factor(4.0)               # the card's
    port_cal.set_measured_kernel_factor(0.5, backend="cpu")
    port_cal.set_measured_kernel_factor(9.0, kernel="frontier_pull",
                                        backend="cpu")
    assert fresh_factors == {("cuda", "frontier_expand"): 4.0,
                             ("cpu", "frontier_expand"): 0.5,
                             ("cpu", "frontier_pull"): 9.0}
    assert port_cal.measured_kernel_factor(device="cpu") == 0.5
    assert port_cal.measured_kernel_factor(kernel="frontier_pull",
                                           device="cpu") == 9.0
    # the default device is the card: no card, no measurement
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cal.measured_kernel_factor()
    state = port_cal.measured_factors_state()
    assert state == {"cuda/frontier_expand": 4.0,
                     "cpu/frontier_expand": 0.5, "cpu/frontier_pull": 9.0}
    fresh_factors.clear()
    port_cal.restore_measured_factors(state)
    port_cal.restore_measured_factors({"cpu/frontier_expand": 7.0})
    assert port_cal.measured_kernel_factor(device="cpu") == 0.5
    port_cal.set_measured_kernel_factor(None, backend="cpu")
    assert ("cpu", "frontier_expand") not in fresh_factors


def test_resolve_constants_measures_only_for_a_kernel(fresh_factors,
                                                      monkeypatch):
    calls = []

    def fake(*, kernel="frontier_expand", refresh=False, device=None):
        calls.append((kernel, device))
        return 7.0
    monkeypatch.setattr(port_cal, "measured_kernel_factor", fake)
    plain = port_cal.resolve_constants(None, need_kernel=False,
                                       device="cpu")
    assert plain.kernel_factor is None and calls == []
    kern = port_cal.resolve_constants(None, need_kernel=True, device="cpu")
    assert kern.kernel_factor == 7.0 and calls == [("frontier_expand",
                                                    "cpu")]
    pinned = port_cal.resolve_constants(PortConstants(kernel_factor=1.5),
                                        need_kernel=True, device="cpu")
    assert pinned.kernel_factor == 1.5 and len(calls) == 1


def test_kernel_plug_ins_are_the_kernel_wrappers():
    from repro_torch.kernels.frontier_expand.ops import frontier_expand_fused
    from repro_torch.kernels.frontier_pull.ops import frontier_pull_fused
    assert port_cal.kernel_expand_fn() is frontier_expand_fused
    assert port_cal.kernel_pull_fn() is frontier_pull_fused
