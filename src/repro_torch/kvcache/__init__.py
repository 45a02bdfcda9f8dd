"""Unified distributed KV cache pool at single-token granularity."""
from repro_torch.kvcache.pool import KVPool, OutOfSlots  # noqa: F401
from repro_torch.kvcache.distributed import DistributedKVPool, PlacementPlan  # noqa: F401
