"""Share of the window in the executor's host epilogue, in %: the
program's `executor.sample` spans (`repro_torch.obs`: the host's
bookkeeping of the ids sampled on the device, one a row, with the value
guard's quarantine, the tokens and the new KV's stash)."""
from esp_bench.timeline import window


def read(rec):
    recs = window(rec)
    if recs is None:
        return None
    s = sum(b - a for n, a, b, _ in recs if n == "executor.sample")
    return 100.0 * s / rec.window_s
