"""Bytes copied from the device to the host per token emitted in the
window: the values of the program's `executor.d2h` spans over those of its
`executor.sample` spans (`repro_torch.obs`)."""
from esp_bench.timeline import window


def read(rec):
    recs = window(rec)
    if recs is None:
        return None
    copied = sum(v or 0 for n, _, _, v in recs if n == "executor.d2h")
    tokens = sum(v or 0 for n, _, _, v in recs if n == "executor.sample")
    return copied / tokens if tokens else None
