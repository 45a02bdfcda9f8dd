"""The arithmetic of the end-to-end metrics, on plain numbers.

A request's stamps are host-clock seconds: ``due`` (when it fell due),
``first`` (when the executor call that produced its first token returned;
None if it has none yet) and ``tokens`` (one stamp per output token, the
first token included).  The window runs from ``t0`` to ``t_close``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def pct(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile by nearest rank: the smallest value with at
    least q % of the values at or below it.  None for no values."""
    v = sorted(values)
    if not v:
        return None
    k = max(math.ceil(q / 100.0 * len(v)), 1)
    return float(v[k - 1])


def ttft_waits(reqs: Iterable[Dict], t0: float, t_end: float,
               t_close: float) -> List[float]:
    """Time to first token of every request due in [t0, t_end): its first
    token's stamp minus its due time, or, for one with no first token by
    the close, the wait so far (t_close - due)."""
    out = []
    for r in reqs:
        if not t0 <= r["due"] < t_end:
            continue
        first = r.get("first")
        done = first is not None and first <= t_close
        out.append((first if done else t_close) - r["due"])
    return out


def token_gaps(reqs: Iterable[Dict], t0: float, t_close: float) -> List[float]:
    """Every gap between consecutive output tokens of a request, both
    stamped inside the window."""
    out = []
    for r in reqs:
        ts = [t for t in r.get("tokens", ()) if t0 <= t <= t_close]
        out += [b - a for a, b in zip(ts, ts[1:])]
    return out


def served_split(reqs: Iterable[Dict], t0: float, t_close: float) -> Tuple[int, int]:
    """(prompt tokens of prefills that completed in the window, each
    request's prompt once: a recompute after preemption is not served
    again; output tokens stamped in the window)."""
    prompt = output = 0
    for r in reqs:
        pf = r.get("prefilled")
        if pf is not None and t0 <= pf <= t_close:
            prompt += r["prompt_len"]
        output += sum(1 for t in r.get("tokens", ()) if t0 <= t <= t_close)
    return prompt, output


def served_tokens(reqs: Iterable[Dict], t0: float, t_close: float) -> int:
    """Prompt plus output tokens served in the window (`served_split`)."""
    return sum(served_split(reqs, t0, t_close))
