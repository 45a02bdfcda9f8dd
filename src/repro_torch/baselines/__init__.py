"""Baseline serving systems on the shared engine substrate (§7 comparison)."""
from repro_torch.baselines.static_tp import StaticTPEngine  # noqa: F401
from repro_torch.baselines.chunked_prefill import ChunkedPrefillEngine  # noqa: F401
from repro_torch.baselines.pd_disagg import PDDisaggEngine  # noqa: F401
from repro_torch.baselines.fixed_groups import FixedGroupsEngine  # noqa: F401
