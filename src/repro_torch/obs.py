"""The serving path's recorder: spans and point marks on one host clock.

A span times one stage of a call (``with obs.span("executor.launch"):``),
a mark counts one decision (``obs.mark("scheduler.delay")``).  Both go
into one ring of fixed size as ``(name, start, end, value)`` records, a
mark with ``start == end``; ``value`` is an optional number (rows, bytes,
tokens; None where the record has none).  The clock is
`time.perf_counter`, the clock a device trace of the process is mapped
onto, so program spans and device operations share one timeline.

The recorder is always on.  It records stages of calls, never rows: a
decode call of 725 rows makes as many records as one of 4.  When the ring
is full the oldest record is dropped and counted; `intact(t0)` says
whether every record that ended at or after ``t0`` is still held.
`snapshot()` keeps per-name totals since the process started, dropped
records included: count, seconds, exclusive seconds (a span's
time less its children's) and the sum of values.

Spans nest by the order of entry and exit, one thread: the serving engine
runs in one.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

clock = time.perf_counter
CAPACITY = 1 << 16


class Record(NamedTuple):
    name: str
    start: float
    end: float
    value: Optional[float]


class _Span:
    __slots__ = ("rec", "name", "value", "start", "child")

    def __init__(self, rec: "Recorder", name: str, value) -> None:
        self.rec, self.name, self.value, self.child = rec, name, value, 0.0

    def __enter__(self) -> "_Span":
        self.rec._open.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = clock()
        rec = self.rec
        rec._open.pop()
        dur = end - self.start
        if rec._open:
            rec._open[-1].child += dur
        rec._put((self.name, self.start, end, self.value), dur,
                 dur - self.child)
        return False


class Recorder:
    def __init__(self, capacity: int = CAPACITY) -> None:
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._open: List[_Span] = []
        self._totals: Dict[str, list] = {}
        self.dropped = 0
        self._lost_until = float("-inf")  # end of the newest dropped record

    def span(self, name: str, value=None) -> _Span:
        return _Span(self, name, value)

    def mark(self, name: str, value=None) -> None:
        t = clock()
        self._put((name, t, t, value), 0.0, 0.0)

    def _put(self, r: tuple, dur: float, excl: float) -> None:
        ring = self._ring
        if len(ring) == self.capacity:
            self.dropped += 1
            self._lost_until = ring[0][2]  # records enter in order of end
        ring.append(r)
        t = self._totals.get(r[0])
        if t is None:
            t = self._totals[r[0]] = [0, 0.0, 0.0, 0.0]
        t[0] += 1
        t[1] += dur
        t[2] += excl
        if r[3] is not None:
            t[3] += r[3]

    def records(self, t0: float = float("-inf"),
                t1: float = float("inf")) -> List[Record]:
        """The held records that overlap [t0, t1], in order of end."""
        return [Record(*r) for r in self._ring if r[2] >= t0 and r[1] <= t1]

    def intact(self, t0: float) -> bool:
        """True when no record that ended at or after `t0` was dropped."""
        return self._lost_until < t0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {n: {"count": c, "seconds": s, "exclusive_s": e, "value": v}
                for n, (c, s, e, v) in sorted(self._totals.items())}


_REC = Recorder()


def span(name: str, value=None) -> _Span:
    """A context manager recording one span; its ``value`` may be set inside
    (``with obs.span("executor.d2h") as s: ...; s.value = nbytes``)."""
    return _REC.span(name, value)


def mark(name: str, value=None) -> None:
    """A point record."""
    _REC.mark(name, value)


def records(t0: float = float("-inf"),
            t1: float = float("inf")) -> List[Record]:
    return _REC.records(t0, t1)


def intact(t0: float) -> bool:
    return _REC.intact(t0)


def snapshot() -> Dict[str, Dict[str, float]]:
    return _REC.snapshot()
