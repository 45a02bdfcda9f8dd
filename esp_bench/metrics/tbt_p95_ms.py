"""95th percentile of every gap between consecutive output tokens of a
request, both stamped in the window, in milliseconds.  It also reads
``tbt_p95_ms.backlog``, the per-layer name of the same tail in backlog
cells: there each decode call's host work paces the tokens, so the tail
follows the host's pace run to run and is not bounded."""
from esp_bench.stats import pct, token_gaps


def read(rec):
    p = pct(token_gaps(rec.reqs, rec.t0, rec.t_close), 95)
    return None if p is None else p * 1e3
