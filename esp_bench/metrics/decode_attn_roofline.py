"""K2 (the paged split-K decode kernel and its merge) against its
roofline: the least time of the window's decode attention work (each row's
K and V read once in bf16) over the kernels' device time, in %."""
from esp_bench import workcount as wc


def read(rec):
    if rec.kernels is None:
        return None
    t = sum(b - a for n, a, b in rec.kernels
            if "PagedRows" in n or "merge_kernel" in n)
    ctx = [x for c in rec.calls if c["kind"] == "decode" for x in c["ctx"]]
    if t <= 0 or not ctx:
        return None
    least = wc.bound_s(wc.decode_attn_flops(rec.cfg, ctx),
                       wc.decode_attn_bytes(rec.cfg, ctx))
    return 100.0 * least / t
