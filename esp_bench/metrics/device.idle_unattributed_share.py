"""Share of the traced window with no device operation and no program span
(`repro_torch.obs`) open, in %: idle time the program's records cannot
place."""
from esp_bench.timeline import idle_share


def read(rec):
    return idle_share(rec, None)
