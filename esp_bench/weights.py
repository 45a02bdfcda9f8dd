"""The weights of a run, drawn by the benchmark on the device from the
seed, in the port's parameter layout (key names and stacked ``[L, ...]``
leaves as `src/repro_torch/convert.py` documents them).  The leaves are
those that the configuration's reference module lists in its
``shapes(cfg)`` (`esp_bench/lookup.py`).  The same tensors go to the port
and to the reference.

Three draws in all, each one call over one flat buffer in the served
type: every product weight (and the embedding) ~ N(0, 0.02); every norm
scale 1 + N(0, 0.1) (so that a norm applied wrongly shows); every bias
(qkv, layernorm) ~ N(0, 0.02).  The leaves are views into the buffers.
"""
from __future__ import annotations

from typing import Dict

import torch

from esp_bench import lookup

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def draw(cfg: dict, seed: int, device) -> Dict:
    """The parameter tree of `cfg` on `device`, from `seed`."""
    dt = DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    tree: Dict = {}
    groups = lookup.reference(cfg).shapes(cfg)
    for group, mean, std in zip(groups, (0.0, 1.0, 0.0), (0.02, 0.1, 0.02)):
        if not group:
            continue
        flat = torch.empty(sum(_numel(s) for _, s in group), dtype=dt,
                           device=device)
        flat.normal_(mean, std, generator=g)
        at = 0
        for path, shape in group:
            leaf = flat[at:at + _numel(shape)].view(shape)
            at += _numel(shape)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
    return tree

