"""Share of the traced window with no device operation while the innermost
open program span (`repro_torch.obs`) is `executor.launch`, the model
call's launch on the host, in %."""
from esp_bench.timeline import idle_share


def read(rec):
    return idle_share(rec, "executor.launch")
