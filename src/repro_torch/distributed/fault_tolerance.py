"""Fault-tolerance logic: straggler detection.

Pure, clock-injected logic (unit-testable without hardware):
``StragglerMonitor`` keeps an EMA of step (or bucket dispatch) wall times
with a deadline multiplier and flags slow steps, so a launcher can
re-dispatch or skip them.  The serving session feeds it every measured
bucket dispatch and the bucket executor
(:func:`repro_torch.core.engine.dispatch_buckets`) reads ``expected`` to
decide skip-vs-launch under a deadline.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    ema_decay: float = 0.9
    deadline_factor: float = 2.5
    warmup_steps: int = 5

    _ema: float = 0.0
    _count: int = 0
    stragglers: int = 0

    def record(self, step_time: float) -> bool:
        """Record a step time; True -> the step straggled (re-dispatch)."""
        self._count += 1
        if self._count <= self.warmup_steps:
            self._ema = step_time if self._ema == 0.0 else (
                self.ema_decay * self._ema
                + (1 - self.ema_decay) * step_time)
            return False
        is_straggler = step_time > self.deadline_factor * self._ema
        if is_straggler:
            self.stragglers += 1
        else:                       # stragglers don't poison the EMA
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * step_time)
        return is_straggler

    @property
    def deadline(self) -> float:
        return self.deadline_factor * self._ema if self._count else float(
            "inf")

    @property
    def expected(self) -> float:
        """EMA-predicted next step time (0.0 until warm-up completes).

        The serving executor's deadline budgeting reads this to decide
        skip-vs-launch BEFORE paying a bucket's dispatch cost: if the
        predicted wall time does not fit the request's remaining budget,
        the bucket is skipped instead of silently blocking past the
        deadline.  Returning 0.0 while cold means a cold monitor never
        vetoes a launch — only the hard budget does."""
        return self._ema if self._count >= self.warmup_steps else 0.0
