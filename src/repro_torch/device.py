"""Device resolution for the port's entry points.

Every entry point (`build_model`, `init_params`, `LoongServeEngine`) takes an
explicit ``device=`` that defaults to ``"cuda"``.  Asking for CUDA where no
CUDA device exists raises; nothing falls back to the CPU by itself — the CPU
is used only when the caller names it (as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU"
        )
    return dev
