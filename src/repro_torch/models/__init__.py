"""Model zoo (PyTorch): every architecture of the reference, driven by
ModelConfig."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda", **kwargs):
    """Factory: the model class of the config's family on `device`
    (``"cuda"`` by default; raises when no CUDA device exists — pass
    ``device="cpu"`` explicitly)."""
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import EncDecModel

        return EncDecModel(cfg, device=device, **kwargs)
    from repro_torch.models.transformer import Model

    return Model(cfg, device=device, **kwargs)
