"""The program's own records (`repro_torch.obs`: spans and marks on the
host clock, the clock the device trace is mapped onto) in a run's window,
for the readers of `metrics/`.

A program without the recorder, or whose ring dropped a record that ended
inside the window, gives None, and so do the readers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from esp_bench.trace import busy


def window(rec) -> Optional[List[tuple]]:
    """The records overlapping [rec.t0, rec.t_close], clipped to it, as
    (name, start, end, value)."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if not obs.intact(rec.t0):
        return None
    t0, t1 = rec.t0, rec.t_close
    return [(n, max(a, t0), min(b, t1), v)
            for n, a, b, v in obs.records(t0, t1)]


def innermost(records, t0: float,
              t1: float) -> List[Tuple[Optional[str], float, float]]:
    """[t0, t1] cut into pieces, each with the innermost open span (None
    where none is open).  Spans nest (one thread), so the innermost is the
    latest started of those open; marks have no length and open nothing."""
    out: List[Tuple[Optional[str], float, float]] = []
    stack: List[Tuple[str, float]] = []  # (name, end), outermost first
    t = t0

    def emit(name, b):
        nonlocal t
        if b > t:
            out.append((name, t, b))
            t = b

    for name, a, b, _ in sorted(records, key=lambda r: (r[1], -r[2])):
        if b <= a:
            continue
        while stack and stack[-1][1] <= a:
            emit(*stack.pop())
        emit(stack[-1][0] if stack else None, a)
        stack.append((name, b))
    while stack:
        emit(*stack.pop())
    emit(None, t1)
    return out


def idle(kernels, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The parts of [t0, t1] in which no operation ran on the device."""
    edges = [t0] + [x for iv in busy(kernels) for x in iv] + [t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def overlap(pieces, intervals) -> Dict[Optional[str], float]:
    """Seconds of `intervals` (sorted, disjoint) under each piece's name."""
    out: Dict[Optional[str], float] = {}
    i = 0
    for name, a, b in pieces:
        while i < len(intervals) and intervals[i][1] <= a:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < b:
            x, y = intervals[j]
            out[name] = out.get(name, 0.0) + min(b, y) - max(a, x)
            j += 1
    return out


def idle_share(rec, name: Optional[str]) -> Optional[float]:
    """Share of the window, in %, with no device operation while `name` is
    the innermost open span (None: while no span is open)."""
    recs = window(rec)
    if recs is None or rec.kernels is None:
        return None
    pieces = innermost(recs, rec.t0, rec.t_close)
    gaps = idle(rec.kernels, rec.t0, rec.t_close)
    return 100.0 * overlap(pieces, gaps).get(name, 0.0) / rec.window_s
