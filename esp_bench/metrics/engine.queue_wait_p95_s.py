"""95th percentile over the requests due in the window of due time to the
start of the executor call that begins the request's prefill (the wait so
far for one not begun by the close)."""
from esp_bench.stats import pct


def read(rec):
    w = [(d["started"] if d["started"] is not None else rec.t_close) - d["due"]
         for d in rec.reqs if rec.t0 <= d["due"] < rec.t_end]
    return pct(w, 95)
