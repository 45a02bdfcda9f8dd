"""Architecture registry: ``--arch <id>`` resolves through here."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES, reduced

from repro_torch.configs import (  # noqa: F401
    qwen1_5_4b,
    glm4_9b,
    nemotron_4_15b,
    h2o_danube_1_8b,
    zamba2_2_7b,
    xlstm_350m,
    mixtral_8x7b,
    arctic_480b,
    pixtral_12b,
    whisper_tiny,
    lwm_7b,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen1_5_4b,
        glm4_9b,
        nemotron_4_15b,
        h2o_danube_1_8b,
        zamba2_2_7b,
        xlstm_350m,
        mixtral_8x7b,
        arctic_480b,
        pixtral_12b,
        whisper_tiny,
        lwm_7b,
    )
}

# The ten *assigned* architectures (lwm-7b is the paper's own model, extra).
ASSIGNED = [
    "qwen1.5-4b",
    "glm4-9b",
    "nemotron-4-15b",
    "h2o-danube-1.8b",
    "zamba2-2.7b",
    "xlstm-350m",
    "mixtral-8x7b",
    "arctic-480b",
    "pixtral-12b",
    "whisper-tiny",
]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason) for an (arch x shape) cell, per DESIGN.md §4."""
    if shape.name == "long_500k" and cfg.has_full_attention:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention (DESIGN.md §4)"
    return True, ""


__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "REGISTRY",
    "ASSIGNED",
    "get_config",
    "reduced",
    "shape_applicable",
]
