"""Share of the window the engine's own host work holds the loop, in %:
the exclusive time (children's time taken out) of the program's
`engine.schedule` and `engine.decode_epilogue` spans (`repro_torch.obs`)."""
from esp_bench.timeline import innermost, window

NAMES = ("engine.schedule", "engine.decode_epilogue")


def read(rec):
    recs = window(rec)
    if recs is None:
        return None
    pieces = innermost(recs, rec.t0, rec.t_close)
    s = sum(b - a for n, a, b in pieces if n in NAMES)
    return 100.0 * s / rec.window_s
