"""Each bucket's own time in the port's bucket executor.

``dispatch_buckets`` dispatches each bucket just before it reads it, so a
bucket's ``BucketTiming.elapsed_us`` covers its own dispatch, retries,
evictions, finish and host copy and nothing of another bucket's.  A stub
``dispatch`` sleeps a known, different time for each bucket (and for each
re-dispatch) and returns a batched ``BFSResult`` whose lanes carry their
root.  The sleeps advance a fake clock that stands in for the executor's
``time`` module, so the timings are exact and the host's load cannot
move them: each bucket's ``elapsed_us`` must equal its own sleeps (its
dispatches and its ``finish`` calls), below their sum, and the lanes, the
retry, the eviction, the report and the order of the dispatches must be
what the executor has always produced.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as port
from repro_torch.core.operators import BFSResult

FALLBACK = port.EngineCaps(64, 256)
SMALL = port.EngineCaps(8, 32)
# the seconds each dispatch sleeps: by bucket, then for a re-dispatch
SLEEP_S = {0: 0.04, 1: 0.015, 2: 0.07}
REDISPATCH_S = 0.02
FINISH_S = 0.001        # each finish call
# float rounding of the fake clock's sums, in seconds
ROUNDING_S = 1e-9


class FakeClock:
    """The executor's ``time`` module: ``perf_counter`` reads seconds that
    only ``sleep`` advances."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += seconds


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(port, "time", fake)
    return fake


@dataclasses.dataclass(frozen=True)
class Bucket:
    indices: tuple
    roots: tuple
    caps: port.EngineCaps


BUCKETS = (Bucket((0, 3), (10, 13), FALLBACK),    # no overflow check
           Bucket((1, 4), (11, 14), SMALL),       # lane 1 overflows: evicted
           Bucket((2,), (12,), SMALL))            # overflows: retried


def stub(calls: list):
    def dispatch(i, b, caps):
        calls.append((i, tuple(b.roots), caps))
        first = sum(1 for c in calls if c[0] == i) == 1
        port.time.sleep(SLEEP_S[i] if first else REDISPATCH_S)
        roots = torch.tensor(b.roots, dtype=torch.int32)
        small = caps != FALLBACK
        overflow = torch.tensor([small and (r == 14 or r == 12)
                                 for r in b.roots])
        lanes = len(b.roots)
        return BFSResult(
            values={"id": roots[:, None].repeat(1, 3)},
            positions=roots[:, None].repeat(1, 3),
            count=roots, depth=torch.full((lanes,), caps.frontier,
                                          dtype=torch.int32),
            overflow=overflow)
    return dispatch


def run(**kwargs):
    calls, timings, finished = [], [], []
    report = port.DispatchReport()

    def finish(i, b, r):
        finished.append((i, tuple(b.roots)))
        port.time.sleep(FINISH_S)
        return r
    before = (port.overflow_retry_count(), port.lane_eviction_count())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # retry warning
        out = port.dispatch_buckets(BUCKETS, stub(calls),
                                    fallback_caps=FALLBACK,
                                    observer=timings.append, finish=finish,
                                    report=report, **kwargs)
    deltas = (port.overflow_retry_count() - before[0],
              port.lane_eviction_count() - before[1])
    return out, calls, timings, finished, report, deltas


@pytest.mark.parametrize("to_host", [False, True])
def test_each_bucket_is_timed_on_its_own(to_host):
    out, calls, timings, finished, report, deltas = run(to_host=to_host)
    assert [t.index for t in timings] == [0, 1, 2]
    # bucket 1 finishes its result and its evicted lane's, bucket 2 its
    # retried result
    own = {0: SLEEP_S[0] + FINISH_S, 1: SLEEP_S[1] + REDISPATCH_S
           + 2 * FINISH_S, 2: SLEEP_S[2] + REDISPATCH_S + FINISH_S}
    total = sum(own.values())
    for t in timings:
        s = t.elapsed_us / 1e6
        assert abs(s - own[t.index]) < ROUNDING_S, (t, own)
        # none of another bucket's sleeps: an executor that launched every
        # bucket before reading any charged them all to the first
        assert s < own[t.index] + min(own.values()) < total
    # each bucket is dispatched just before it is read: bucket 1's
    # eviction comes before bucket 2's first dispatch
    assert calls == [(0, (10, 13), FALLBACK), (1, (11, 14), SMALL),
                     (1, (14,), FALLBACK), (2, (12,), SMALL),
                     (2, (12,), FALLBACK)]


def test_lanes_retries_and_evictions_are_unchanged():
    out, calls, timings, finished, report, deltas = run(to_host=True)
    # every lane back in root order, the evicted and retried lanes from
    # their fallback dispatches
    assert [int(r.count) for r in out] == [10, 11, 12, 13, 14]
    assert [int(r.depth) for r in out] == [
        FALLBACK.frontier, SMALL.frontier, FALLBACK.frontier,
        FALLBACK.frontier, FALLBACK.frontier]
    assert not any(bool(r.overflow) for r in out)
    assert [(t.retried, t.evicted_lanes, t.caps, t.predicted_caps, t.lanes,
             t.padded_lanes) for t in timings] == [
        (False, 0, FALLBACK, FALLBACK, 2, 2),
        (False, 1, SMALL, SMALL, 2, 2),
        (True, 0, FALLBACK, SMALL, 1, 1)]
    assert (report.retries, report.evictions) == (1, 1)
    assert deltas == (1, 1)
    assert report.denied_buckets == report.skipped_buckets == []
    assert finished == [(0, (10, 13)), (1, (11, 14)), (1, (14,)),
                        (2, (12,))]


def test_a_deadline_still_skips_after_the_first_bucket():
    out, calls, timings, _, report, _ = run(deadline_us=1.0)
    assert report.skipped_buckets == [1, 2]
    assert out[1] is port.SKIPPED and out[2] is port.SKIPPED
    assert [c[0] for c in calls] == [0]
    assert abs(timings[0].elapsed_us / 1e6 - SLEEP_S[0] - FINISH_S) \
        < ROUNDING_S
