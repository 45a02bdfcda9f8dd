"""Synthetic workload generation (paper §7.1 datasets + Poisson arrivals)."""
from repro_torch.data.workload import poisson_workload, zipf_workload, sample_lengths, with_prompts  # noqa: F401
