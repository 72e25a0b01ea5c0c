"""Serving metrics: counters, gauges and bounded-memory latency histograms.

The registry is deliberately tiny — a serving session needs hit rates,
retry counts and latency quantiles, not a metrics vendor.  Three
constraints shape it:

* **bounded memory** — a histogram holds a FIXED set of log-spaced buckets
  (plus count/sum/min/max), so a session serving forever never grows its
  metrics footprint; quantiles are interpolated within the winning bucket
  (log-spaced buckets bound the relative error by the bucket ratio);
* **no dependencies** — plain Python, importable from anywhere in the
  stack without cycles (this module must stay a leaf);
* **Prometheus-style text** — :meth:`MetricsRegistry.render_text` emits
  the standard exposition format (``# TYPE`` headers, cumulative
  ``_bucket{le=...}`` series), something a real scraper would accept.

Single-threaded by design, matching the serving session (one request at a
time per session); there are no locks.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotonically increasing count."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n


class Gauge:
    """A value that can go up and down."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """A fixed-footprint log-bucketed histogram with interpolated quantiles.

    Bucket upper bounds are geometric: ``per_decade`` buckets per factor of
    10 between ``lo`` and ``hi`` (values outside clamp into the end
    buckets), so p50/p95/p99 carry a bounded RELATIVE error of one bucket
    ratio (~33% per bucket at the default 8/decade — tight enough to rank
    latency regressions) while total storage stays a few hundred floats
    regardless of how many observations arrive."""

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, help: str = "", *, lo: float = 1.0,
                 hi: float = 1e9, per_decade: int = 8):
        if not (lo > 0 and hi > lo):
            raise ValueError("need 0 < lo < hi")
        self.name = name
        self.help = help
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        ratio = (hi / lo) ** (1.0 / max(n - 1, 1))
        self.bounds = [lo * ratio ** i for i in range(n)]   # upper edges
        self.counts = [0] * (n + 1)                          # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        idx = len(self.bounds)                   # overflow bucket
        for i, b in enumerate(self.bounds):      # few hundred bounds max
            if v <= b:
                idx = i
                break
        self.counts[idx] += 1

    def quantile(self, q: float) -> float:
        """The q-quantile (0..1), interpolated inside the winning bucket.
        NaN with no observations; exact at the observed min/max ends."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(self.min,
                                                          self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(max(hi, lo), self.max)
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.max

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max),
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Get-or-create registry over the three instrument kinds, with a dict
    snapshot (``to_dict``) and a Prometheus-style rendering
    (``render_text``).  Names are conventional Prometheus identifiers
    (``snake_case``, ``_total`` suffix on counters, unit suffixes like
    ``_us``)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", **kwargs) -> Histogram:
        return self._get(name, Histogram, help=help, **kwargs)

    def __iter__(self) -> Iterable:
        return iter(self._metrics.values())

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def to_dict(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

    @staticmethod
    def _fmt(v: float) -> str:
        if v == math.inf:
            return "+Inf"
        if float(v).is_integer():
            return str(int(v))
        return repr(float(v))

    def render_text(self) -> str:
        """Prometheus exposition format: ``# HELP``/``# TYPE`` headers,
        cumulative ``_bucket{le=...}`` series for histograms."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {self._fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {self._fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{self._fmt(b)}"}} '
                                 f"{cum}")
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {self._fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")
