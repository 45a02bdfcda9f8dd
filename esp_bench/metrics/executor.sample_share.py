"""Share of the window in host sampling, in %: the program's
`executor.sample` spans (`repro_torch.obs`: the value guard and greedy
sampling over each call's logits rows, and the new KV's stash)."""
from esp_bench.timeline import window


def read(rec):
    recs = window(rec)
    if recs is None:
        return None
    s = sum(b - a for n, a, b, _ in recs if n == "executor.sample")
    return 100.0 * s / rec.window_s
