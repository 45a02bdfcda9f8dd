"""Prompt tokens whose prefill completed plus output tokens emitted, all
in the window, over the window's seconds."""
from esp_bench.stats import served_tokens


def read(rec):
    return served_tokens(rec.reqs, rec.t0, rec.t_close) / rec.window_s
