"""A configuration's plain reference, found by name as the metrics and the
traffic mixes are: ``esp_bench/reference/<family>.py``, by the
configuration's ``family``.

The module defines the model (``logits_at``) and its weight tree
(``shapes``).  It may define ``rehearse(cfg) -> cfg`` and the counts of
`esp_bench/workcount.py`, one group (`COUNTS`) whole or none of it: a
count of the group that it left out would be the dense formula, which
misstates another family's work (all experts' FFN, every key of a window
layer).
"""
from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent

COUNTS = (("decode_flops", "decode_bytes", "decode_attn_flops", "decode_attn_bytes"),
          ("prefill_flops", "prefill_attn_flops", "prefill_attn_bytes"))


def reference(cfg: dict):
    """The reference module of `cfg` (a hand-made dict with no ``family``,
    as the count tests use, reads ``dense``)."""
    name = cfg.get("family", "dense")
    if not (HERE / "reference" / f"{name}.py").is_file():
        raise FileNotFoundError(
            f"no reference esp_bench/reference/{name}.py for the configuration "
            f"{cfg.get('name')}")
    mod = importlib.import_module(f"esp_bench.reference.{name}")
    validate(mod)
    return mod


def validate(mod) -> None:
    """Refuse a reference module that lacks the model or the weight tree, or
    that states part of a group of counts."""
    for need in ("logits_at", "shapes"):
        if not callable(getattr(mod, need, None)):
            raise TypeError(f"{mod.__name__} defines no {need}")
    for group in COUNTS:
        own = [n for n in group if hasattr(mod, n)]
        if own and len(own) < len(group):
            raise TypeError(
                f"{mod.__name__} defines {', '.join(own)} but not "
                f"{', '.join(n for n in group if n not in own)}: a family "
                "states a group of counts whole or not at all")
