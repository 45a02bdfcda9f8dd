"""Global manager: four-step scheduler, DP batching, SIB analytical model."""
from repro_torch.manager.sib import SIB, HardwareSpec, PrefillCoeffs, DecodeCoeffs  # noqa: F401
from repro_torch.manager.batching import dp_batching, dp_batching_naive, BatchSplit, make_prefill_cost  # noqa: F401
from repro_torch.manager.scheduler import (  # noqa: F401
    GlobalManager, ManagerConfig, IterationPlan, PrefillBatch, DecodeBatch, Migration,
)
