"""Model zoo (PyTorch): every architecture of the reference, driven by
ModelConfig."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, attn_impl=None, constrain=None,
                remat: bool = False, *, device="cuda"):
    """Factory: the model class of the config's family on `device`
    (``"cuda"`` by default; raises when no CUDA device exists — pass
    ``device="cpu"`` explicitly).  `attn_impl`, `constrain` and `remat` as
    in the reference's ``build_model``."""
    kw = dict(attn_impl=attn_impl, constrain=constrain, remat=remat,
              device=device)
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import EncDecModel

        return EncDecModel(cfg, **kw)
    from repro_torch.models.transformer import Model

    return Model(cfg, **kw)
