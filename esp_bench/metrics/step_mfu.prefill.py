"""The prefill calls' model FLOPs (products and causal attention of their
prompts, counted in `esp_bench/workcount.py`) over their wall times the
H100's dense bf16 peak, in %."""
from esp_bench import workcount as wc


def read(rec):
    calls = [c for c in rec.calls if c["kind"] == "prefill"]
    wall = sum(c["end"] - c["start"] for c in calls)
    if not calls or wall <= 0:
        return None
    flops = sum(wc.prefill_flops(rec.cfg, c["lens"]) for c in calls)
    return 100.0 * flops / (wall * wc.PEAK_FLOPS)
