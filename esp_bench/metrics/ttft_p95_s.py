"""95th percentile over every request due in the window of its due time
to its first token; one with no first token by the close counts with its
wait so far."""
from esp_bench.stats import pct, ttft_waits


def read(rec):
    return pct(ttft_waits(rec.reqs, rec.t0, rec.t_end, rec.t_close), 95)
