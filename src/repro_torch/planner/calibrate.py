"""Self-calibrating cost model: close the loop from MEASURED latencies back
into the planner's :class:`~repro_torch.planner.cost.CostConstants`.

The cost model prices a plan as ``base + level_us * levels +
(plain_bytes + kernel_factor * kernel_bytes) / bytes_per_us``
(:func:`repro_torch.planner.cost.estimate_us`).  The four constants were
hand-calibrated for one CPU profile; on another device the ranking can
silently invert.  This module makes them measured:

* a serving layer times every dispatched bucket (the bucket executor,
  :func:`repro_torch.core.engine.dispatch_buckets`, reports each one) and
  feeds each ``(plan signature, levels, plain_bytes, kernel_bytes,
  measured_us)`` observation to a :class:`Calibrator`;
* the calibrator accumulates the least-squares NORMAL EQUATIONS online
  (O(16) state, no sample buffer needed to refit) for the model above,
  which is linear in ``w = [base_us, level_us, 1/bytes_per_us,
  kernel_factor/bytes_per_us]``;
* :meth:`Calibrator.refit` solves the ridge-anchored system (the prior
  constants regularize degenerate directions — e.g. no kernel traffic yet)
  and returns a new :class:`CostConstants` for every later
  :func:`repro_torch.planner.optimize.plan` call;
* :func:`measured_kernel_factor` times each hand-written kernel against
  its plain version on a device, once per (device type, kernel), cached.

The factors are keyed on the device type (``"cuda"`` / ``"cpu"``), where
the reference keys them on its JAX backend: ``plan()`` measures on the
dataset's device.  On the card the kernel route is the hand-written
kernel; on the CPU it is the kernel's plain version, so the CPU factor is
close to 1.

Calibration state serializes (:meth:`Calibrator.state_dict`) into JSON, so
a warm process resumes with the previous process's fitted constants, and
a state saved by the reference loads here.
"""
from __future__ import annotations

import hashlib
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.csr import build_csr, expand_frontier
from ..core.engine import resolve_device
from ..core.operators import _dense_pull
from ..kernels.frontier_expand.ops import frontier_expand_fused
from ..kernels.frontier_pull.ops import frontier_pull_fused
from ..kernels.spmm_segment.ops import spmm_segment
from .cost import CostConstants, DEFAULT_CONSTANTS
from .stats import GraphStats

__all__ = ["Calibrator", "Observation", "kernel_expand_fn",
           "kernel_pull_fn", "measured_factors_state",
           "measured_kernel_factor", "plan_signature",
           "restore_measured_factors", "resolve_constants",
           "set_measured_kernel_factor", "stats_digest"]


# ---------------------------------------------------------------------------
# plan signatures: what an observation is keyed by
# ---------------------------------------------------------------------------

def stats_digest(stats: GraphStats) -> str:
    """A short stable digest of the graph statistics a plan was priced
    against — observations from different graphs (or a regenerated graph)
    must not be conflated under one signature.  The same string as the
    reference's for the same statistics."""
    h = hashlib.sha1()
    h.update(repr((stats.direction, stats.num_vertices, stats.num_edges,
                   stats.max_degree, stats.is_forest,
                   tuple(round(x, 3) for x in stats.level_edges),
                   tuple(round(x, 3) for x in stats.level_walk_edges),
                   )).encode())
    return h.hexdigest()[:12]


def plan_signature(label: str, direction: str, caps, digest: str,
                   lanes: int = 1, shape: Tuple = (),
                   mix: Tuple = (), workload: str = "reach") -> Tuple:
    """The calibration key of one served plan: engine label (kernel
    included), direction, the bucket's caps, the graph-stats digest, the
    dispatched lane count, the query-shape axes (max_depth, payloads,
    dedup, ...), the semiring ``workload``, and — for
    direction-optimizing plans — the predicted per-level push/pull
    ``mix``.  Lanes and shape matter: a 1-lane and an 8-lane dispatch of
    the same pipeline do different amounts of work, and two query shapes
    clamped to the same caps must not pool their latencies under one
    signature.  So do the mix (a push-heavy and a pull-heavy execution of
    the same diropt pipeline move very different bytes) and the workload
    (a weighted traversal moves the value plane's extra bytes).  Shape and
    mix are canonicalized to strings so signatures stay flat primitives
    and round-trip JSON exactly."""
    return (label, direction, int(caps.frontier), int(caps.result), digest,
            int(lanes), repr(tuple(shape)), repr(tuple(mix)), str(workload))


class Observation(NamedTuple):
    """One measured bucket dispatch, paired with the cost model's inputs."""

    signature: Tuple
    levels: int
    plain_bytes: float
    kernel_bytes: float
    measured_us: float


# ---------------------------------------------------------------------------
# the measured kernel factors
# ---------------------------------------------------------------------------

def kernel_expand_fn():
    """The ``frontier_expand`` kernel wrapper, the plug-in for
    ``CSRIndexJoin.expand_fn`` (on CPU tensors it runs its plain
    version)."""
    return frontier_expand_fused


def kernel_pull_fn():
    """The ``frontier_pull`` kernel wrapper, the plug-in for
    ``PullStep.expand_fn`` (on CPU tensors it runs its plain version)."""
    return frontier_pull_fused


# measured kernel factors, keyed on (device type, kernel name): each device
# type and each kernel gets its own measurement
_MEASURED_KERNEL_FACTORS: dict = {}

# where the port's entry points run unless the caller names a device
DEFAULT_DEVICE_TYPE = "cuda"

_MEASURE_V = 256          # micro-benchmark graph size
_MEASURE_E = 1024
_MEASURE_CAP = 512
_MEASURE_REPEAT = 5

KERNEL_NAMES = ("frontier_expand", "frontier_pull", "spmm_segment")


def set_measured_kernel_factor(value: Optional[float], *,
                               kernel: str = "frontier_expand",
                               backend: Optional[str] = None) -> None:
    """Inject (or, with ``None``, clear) the cached factor for one
    (device type, kernel) cell — used by tests and by a restored state to
    skip the micro-benchmark.  ``backend`` defaults to the port's default
    device type, ``"cuda"``."""
    key = (backend if backend is not None else DEFAULT_DEVICE_TYPE, kernel)
    if value is None:
        _MEASURED_KERNEL_FACTORS.pop(key, None)
    else:
        _MEASURED_KERNEL_FACTORS[key] = float(value)


def measured_factors_state() -> dict:
    """JSON-serializable snapshot of every measured (device type, kernel)
    factor."""
    return {f"{b}/{k}": v for (b, k), v in _MEASURED_KERNEL_FACTORS.items()}


def restore_measured_factors(state: dict) -> None:
    """Seed the per-(device type, kernel) cache from a snapshot (existing
    cells win — this process's own measurements are fresher)."""
    for key, v in (state or {}).items():
        b, _, k = key.partition("/")
        _MEASURED_KERNEL_FACTORS.setdefault((b, k), float(v))


def _median_us(fn, device: torch.device) -> float:
    """Median wall time of ``fn()`` over ``_MEASURE_REPEAT`` calls after one
    warm-up call; on the card each timed call is bracketed by
    ``torch.cuda.synchronize()``."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    ts = []
    for _ in range(_MEASURE_REPEAT):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def _times_us(kern, plain, device: torch.device) -> tuple[float, float]:
    """(kernel, plain) median microseconds, the plain route timed first."""
    t_plain = max(_median_us(plain, device), 1e-3)
    t_kern = max(_median_us(kern, device), 1e-3)
    return t_kern, t_plain


def _measure_expand_factor(device: torch.device) -> tuple[float, float]:
    """The ``frontier_expand`` wrapper against the plain two-phase
    expansion (:func:`repro_torch.core.csr.expand_frontier`)."""
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(0, _MEASURE_V, _MEASURE_E),
                          dtype=torch.int32, device=device)
    csr = build_csr(src, _MEASURE_V)
    targets = torch.as_tensor(rng.integers(0, _MEASURE_V, _MEASURE_CAP),
                              dtype=torch.int32, device=device)
    valid = torch.ones(_MEASURE_CAP, dtype=torch.bool, device=device)
    return _times_us(
        lambda: frontier_expand_fused(csr, targets, valid, _MEASURE_CAP),
        lambda: expand_frontier(csr, targets, valid, _MEASURE_CAP), device)


def _measure_pull_factor(device: torch.device) -> tuple[float, float]:
    """The ``frontier_pull`` wrapper (over the dataset's pull layout, as
    the pulling engines run it) against the plain reverse-CSR pull."""
    from ..core.engine import Dataset
    from ..core.table import ColumnTable

    rng = np.random.default_rng(0)
    src = rng.integers(0, _MEASURE_V, _MEASURE_E).astype(np.int32)
    dst = rng.integers(0, _MEASURE_V, _MEASURE_E).astype(np.int32)
    table = ColumnTable.from_numpy({
        "id": np.arange(_MEASURE_E, dtype=np.int32), "from": src, "to": dst,
        "name": np.zeros((_MEASURE_E, 4), np.float32)}, device)
    ds = Dataset.prepare(table, _MEASURE_V, device=device)
    ds.ensure_reverse()                     # the pull walks it
    if device.type == "cuda":
        ds.ensure_pull_layout("outbound")
    ctx = ds.context("outbound")
    frontier = torch.as_tensor(rng.random(_MEASURE_V) < 0.25,
                               device=device)
    visited = torch.as_tensor(rng.random(_MEASURE_V) < 0.5,
                              device=device) | frontier
    return _times_us(
        lambda: _dense_pull(ctx, frontier, visited, frontier_pull_fused),
        lambda: _dense_pull(ctx, frontier, visited), device)


def _measure_spmm_factor(device: torch.device) -> tuple[float, float]:
    """The ``spmm_segment`` wrapper (its sort included) against the plain
    (sum, ×) scatter, an ``index_add_``, it replaces inside the dense
    weighted step."""
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(0, _MEASURE_V, _MEASURE_E),
                          dtype=torch.int32, device=device)
    dst = torch.as_tensor(rng.integers(0, _MEASURE_V, _MEASURE_E),
                          dtype=torch.int32, device=device)
    w = torch.as_tensor(rng.random(_MEASURE_E), dtype=torch.float32,
                        device=device)
    fval = torch.as_tensor(rng.random(_MEASURE_V), dtype=torch.float32,
                           device=device)

    def plain():
        return torch.zeros(_MEASURE_V, dtype=torch.float32,
                           device=device).index_add_(0, dst.long(),
                                                     fval[src.long()] * w)

    def kern():
        return spmm_segment(fval[:, None], src, dst, w, _MEASURE_V)[:, 0]

    return _times_us(kern, plain, device)


def measured_kernel_factor(*, kernel: str = "frontier_expand",
                           refresh: bool = False, device=None) -> float:
    """MEASURE the relative cost of a hand-written kernel vs its plain
    version on ``device`` (``None``: the card, raising where there is
    none): one tiny synthetic graph (the reference's sizes, seed 0), the
    median of a few timed calls of each.  Cached per (device type,
    kernel): the first pricing on a device type pays it once.

    ``frontier_expand`` times the expansion kernel vs the plain two-phase
    expansion; ``frontier_pull`` the bottom-up kernel vs the plain
    reverse-CSR pull; ``spmm_segment`` the dense ⊕-combine kernel vs the
    plain (sum, ×) scatter the weighted dense step otherwise runs.  On the
    CPU both routes are plain PyTorch, so the factor is near 1."""
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"unknown kernel {kernel!r}; "
                         f"known: {KERNEL_NAMES}")
    device = resolve_device(device)
    key = (device.type, kernel)
    if key in _MEASURED_KERNEL_FACTORS and not refresh:
        return _MEASURED_KERNEL_FACTORS[key]
    t_kern, t_plain = {"frontier_expand": _measure_expand_factor,
                       "frontier_pull": _measure_pull_factor,
                       "spmm_segment": _measure_spmm_factor}[kernel](device)
    factor = float(np.clip(t_kern / t_plain, 1e-3, 1e6))
    _MEASURED_KERNEL_FACTORS[key] = factor
    return factor


def resolve_constants(constants: Optional[CostConstants], *,
                      need_kernel: bool, device=None) -> CostConstants:
    """The constants a planning pass will actually price with: the given
    (or default) constants, with an unresolved ``kernel_factor`` replaced
    by the one measured on ``device`` IFF a kernel candidate is being
    priced (so plain planning never pays the micro-benchmark)."""
    consts = constants if constants is not None else DEFAULT_CONSTANTS
    if need_kernel and consts.kernel_factor is None:
        consts = consts._replace(
            kernel_factor=measured_kernel_factor(device=device))
    return consts


# ---------------------------------------------------------------------------
# the online least-squares calibrator
# ---------------------------------------------------------------------------

_N_PARAMS = 4      # w = [base_us, level_us, 1/bpu, kernel_factor/bpu]


def _kendall_tau(pred, meas) -> float:
    """Kendall rank correlation between predicted and measured times
    (pairs tied on either side contribute nothing)."""
    n = len(pred)
    concordant = discordant = 0
    for i in range(n):
        for j in range(i + 1, n):
            s = (pred[i] - pred[j]) * (meas[i] - meas[j])
            if s > 0:
                concordant += 1
            elif s < 0:
                discordant += 1
    total = n * (n - 1) // 2
    return (concordant - discordant) / total if total else 0.0


class Calibrator:
    """Online refit of :class:`CostConstants` from measured plan latencies.

    Observations accumulate as normal equations (``X^T X`` / ``X^T y``), so
    memory is O(1) in traffic volume; per-signature running means and a
    bounded tail of raw observations are kept for validation, introspection
    and store persistence.

    :meth:`refit` solves the ridge-anchored system — with few observations
    the result stays near the prior, with many the data dominates — and
    then VALIDATES the candidate against the per-signature aggregates
    before adopting it: the new constants must (a) fit the measured
    latencies better than the incumbent (lower RMSE) and (b) actually rank
    the observed plans — positive Kendall tau between predicted and
    measured times.  Measured serving latency includes effects the cost
    model does not carry (dispatch overhead, scheduler noise); when those
    dominate, the honest least-squares direction is garbage and adopting
    it could invert the planner's ranking currency.  Validation makes the
    loop fail SAFE: garbage windows keep the incumbent constants, clean
    windows (the model explains the hardware) move them."""

    def __init__(self, prior: CostConstants = DEFAULT_CONSTANTS, *,
                 min_observations: int = 8, min_signatures: int = 3,
                 ridge: float = 1.0, max_log: int = 256,
                 max_signatures: int = 512):
        self.prior = prior
        self.constants = prior
        self.min_observations = int(min_observations)
        self.min_signatures = int(min_signatures)
        self.ridge = float(ridge)
        self.max_log = int(max_log)
        self.max_signatures = int(max_signatures)
        self._xtx = np.zeros((_N_PARAMS, _N_PARAMS))
        self._xty = np.zeros(_N_PARAMS)
        # signature -> [n, us_sum, levels, plain_bytes, kernel_bytes]
        self._sig_stats: dict = {}
        self.count = 0
        self.kernel_count = 0
        self.refits = 0
        self.rejected_refits = 0
        self.last_rejection: Optional[str] = None
        #   why the last refit's candidate was rejected (None: adopted, or
        #   no refit validated yet)
        self.discarded = 0
        self.log: list[Observation] = []

    # -- recording --------------------------------------------------------
    def observe(self, signature: Tuple, *, levels: int, plain_bytes: float,
                kernel_bytes: float, measured_us: float) -> None:
        """Record one measured dispatch.  ``plain_bytes``/``kernel_bytes``
        are the plan's factor-independent byte split
        (:attr:`~repro_torch.planner.cost.PlanCost.plain_bytes`).

        Non-finite or negative measurements are DISCARDED (counted in
        ``discarded``): a single NaN entering the normal equations would
        poison every later refit, and a clock can glitch — the calibrator
        must never let one bad sample corrupt its state."""
        m = float(measured_us)
        if not np.isfinite(m) or m < 0.0:
            self.discarded += 1
            return
        x = np.array([1.0, float(levels), float(plain_bytes),
                      float(kernel_bytes)])
        self._xtx += np.outer(x, x)
        self._xty += x * float(measured_us)
        self.count += 1
        if kernel_bytes > 0.0:
            self.kernel_count += 1
        sig = tuple(signature)
        slot = self._sig_stats.get(sig)
        if slot is not None:
            slot[0] += 1
            slot[1] += float(measured_us)
        elif len(self._sig_stats) < self.max_signatures:
            self._sig_stats[sig] = [1, float(measured_us), int(levels),
                                    float(plain_bytes), float(kernel_bytes)]
        self.log.append(Observation(sig, int(levels),
                                    float(plain_bytes), float(kernel_bytes),
                                    float(measured_us)))
        if len(self.log) > self.max_log:
            del self.log[: len(self.log) - self.max_log]

    # -- refitting --------------------------------------------------------
    def _prior_w(self) -> np.ndarray:
        kf = self.prior.kernel_factor
        a = 1.0 / self.prior.bytes_per_us
        return np.array([self.prior.base_us, self.prior.level_us, a,
                         (kf if kf is not None else 1.0) * a])

    def _predict(self, constants: CostConstants, levels, plain,
                 kernel) -> float:
        kf = constants.kernel_factor or 0.0
        return (constants.base_us + constants.level_us * levels
                + (plain + kf * kernel) / constants.bytes_per_us)

    def _rejection(self, candidate: CostConstants) -> Optional[str]:
        """The adoption test, on per-signature mean latencies: the
        candidate must fit better than the incumbent AND rank the observed
        plans (tau > 0).  Returns why it fails, or None when it passes."""
        sigs = [(s[2], s[3], s[4], s[1] / s[0])
                for s in self._sig_stats.values()]
        if len(sigs) < self.min_signatures:
            return (f"{len(sigs)} plan signatures observed, "
                    f"{self.min_signatures} needed")
        meas = [m for _, _, _, m in sigs]

        def preds(c):
            return [self._predict(c, lv, p, k) for lv, p, k, _ in sigs]

        def rmse(c):
            return float(np.sqrt(np.mean(
                (np.asarray(preds(c)) - np.asarray(meas)) ** 2)))

        new, old = rmse(candidate), rmse(self.constants)
        tau = _kendall_tau(preds(candidate), meas)
        if new < old and tau > 0.0:
            return None
        return (f"candidate rmse {new:.6g} us against the incumbent's "
                f"{old:.6g} us (must be lower), Kendall tau {tau:.6g} "
                f"(must be > 0)")

    def refit(self) -> CostConstants:
        """Solve + validate; below ``min_observations`` (or when the
        candidate fails validation) the incumbent constants are returned
        unchanged.  The fitted ``kernel_factor`` only replaces the
        incumbent's once kernel traffic has actually been observed."""
        if self.count < self.min_observations:
            return self.constants
        w0 = self._prior_w()
        # ridge anchor, scaled per-parameter so the tiny byte slopes are
        # anchored as strongly (relatively) as the large overhead terms
        lam = np.diag(self.ridge / np.maximum(w0, 1e-12) ** 2)
        w = np.linalg.solve(self._xtx + lam, self._xty + lam @ w0)

        base = float(np.clip(w[0], 0.0, 1e9))
        level = float(np.clip(w[1], 0.0, 1e9))
        a = float(w[2])
        if a <= 0.0:                      # degenerate window: keep bandwidth
            bpu = self.constants.bytes_per_us
            a = 1.0 / bpu
        else:
            bpu = float(np.clip(1.0 / a, self.prior.bytes_per_us / 1e4,
                                self.prior.bytes_per_us * 1e4))
        if self.kernel_count > 0:
            kf = float(np.clip(w[3] / max(a, 1e-18), 1e-3, 1e6))
        else:
            kf = self.constants.kernel_factor
        # _replace keeps the axes the linear model does not fit — notably
        # the pull_alpha/pull_beta switch thresholds — instead of
        # silently resetting them to the defaults on every adopted refit
        candidate = self.constants._replace(
            bytes_per_us=bpu, level_us=level, base_us=base,
            kernel_factor=kf)
        self.last_rejection = self._rejection(candidate)
        if self.last_rejection is not None:
            self.rejected_refits += 1
            return self.constants
        self.constants = candidate
        self.refits += 1
        return self.constants

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable calibration state (goes into the plan store)."""
        return {
            "prior": self.prior.to_json(),
            "constants": self.constants.to_json(),
            "min_observations": self.min_observations,
            "min_signatures": self.min_signatures,
            "ridge": self.ridge,
            "max_log": self.max_log,
            "max_signatures": self.max_signatures,
            "xtx": self._xtx.tolist(),
            "xty": self._xty.tolist(),
            "sig_stats": [{"signature": list(sig), "n": s[0],
                           "us_sum": s[1], "levels": s[2],
                           "plain_bytes": s[3], "kernel_bytes": s[4]}
                          for sig, s in self._sig_stats.items()],
            "count": self.count,
            "kernel_count": self.kernel_count,
            "refits": self.refits,
            "rejected_refits": self.rejected_refits,
            "log": [{"signature": list(o.signature), "levels": o.levels,
                     "plain_bytes": o.plain_bytes,
                     "kernel_bytes": o.kernel_bytes,
                     "measured_us": o.measured_us} for o in self.log],
        }

    @classmethod
    def from_state(cls, state: dict) -> "Calibrator":
        cal = cls(prior=CostConstants.from_json(state["prior"]),
                  min_observations=int(state["min_observations"]),
                  min_signatures=int(state.get("min_signatures", 3)),
                  ridge=float(state["ridge"]),
                  max_log=int(state.get("max_log", 256)),
                  max_signatures=int(state.get("max_signatures", 512)))
        cal.constants = CostConstants.from_json(state["constants"])
        cal._xtx = np.asarray(state["xtx"], dtype=float)
        cal._xty = np.asarray(state["xty"], dtype=float)
        cal._sig_stats = {
            tuple(s["signature"]): [int(s["n"]), float(s["us_sum"]),
                                    int(s["levels"]),
                                    float(s["plain_bytes"]),
                                    float(s["kernel_bytes"])]
            for s in state.get("sig_stats", [])}
        cal.count = int(state["count"])
        cal.kernel_count = int(state["kernel_count"])
        cal.refits = int(state.get("refits", 0))
        cal.rejected_refits = int(state.get("rejected_refits", 0))
        cal.log = [Observation(tuple(o["signature"]), int(o["levels"]),
                               float(o["plain_bytes"]),
                               float(o["kernel_bytes"]),
                               float(o["measured_us"]))
                   for o in state.get("log", [])]
        return cal
