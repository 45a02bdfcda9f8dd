"""Share of the traced window in which no operation ran on the device, in
%."""
from esp_bench.trace import busy


def read(rec):
    if rec.kernels is None:
        return None
    b = sum(y - x for x, y in busy(rec.kernels))
    return 100.0 * (1.0 - b / rec.window_s)
