"""Model zoo (PyTorch): the dense / vlm / moe / hybrid architectures driven by
ModelConfig."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda", **kwargs):
    """Factory: the `Model` of a ported family on `device` (``"cuda"`` by
    default; raises when no CUDA device exists — pass ``device="cpu"``
    explicitly)."""
    from repro_torch.models.transformer import Model

    return Model(cfg, device=device, **kwargs)
