"""K1 and K3 (the `flash_prefill` kernels) against their roofline: the
least time of the window's prefill attention work (causal pairs; q, k, v
and o once in bf16) over the kernels' device time in the trace, in %."""
from esp_bench import workcount as wc


def read(rec):
    if rec.kernels is None:
        return None
    t = sum(b - a for n, a, b in rec.kernels if "flash_prefill" in n)
    lens = [n for c in rec.calls if c["kind"] == "prefill" for n in c["lens"]]
    if t <= 0 or not lens:
        return None
    least = wc.bound_s(sum(wc.prefill_attn_flops(rec.cfg, n) for n in lens),
                       sum(wc.prefill_attn_bytes(rec.cfg, n) for n in lens))
    return 100.0 * least / t
