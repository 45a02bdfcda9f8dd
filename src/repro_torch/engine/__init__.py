"""Serving engine: elastic instances, request lifecycle, iteration loop."""
from repro_torch.engine.request import Request, Phase  # noqa: F401
