"""The decode calls' share of the chip's peak: for each call the larger of
its FLOPs over the bf16 peak and its least bytes (weights once, each row's
K and V once, in bf16) over HBM bandwidth, summed, over their wall, in %."""
from esp_bench import workcount as wc


def read(rec):
    calls = [c for c in rec.calls if c["kind"] == "decode"]
    wall = sum(c["end"] - c["start"] for c in calls)
    if not calls or wall <= 0:
        return None
    least = sum(wc.bound_s(wc.decode_flops(rec.cfg, c["ctx"]),
                           wc.decode_bytes(rec.cfg, c["ctx"])) for c in calls)
    return 100.0 * least / wall
