"""The weights of a run, drawn by the benchmark on the device from the
seed, in the port's parameter layout for the dense family (key names and
stacked ``[L, ...]`` leaves as `src/repro_torch/convert.py` documents
them).  The same tensors go to the port and to the reference.

Three draws in all, each one call over one flat buffer in the served
type: every product weight (and the embedding) ~ N(0, 0.02); every norm
scale 1 + N(0, 0.1) (so that a norm applied wrongly shows); every bias
(qkv, layernorm) ~ N(0, 0.02).  The leaves are views into the buffers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def shapes(cfg: dict) -> Tuple[List, List, List]:
    """(weights, norms, biases): lists of (path, shape) of the tree."""
    d, L, hd = cfg["d_model"], cfg["n_layers"], cfg["d_head"]
    h, kvh, f, v = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"], cfg["vocab_size"]
    w = [(("embed",), (v, d)), (("lm_head",), (d, v)),
         (("layers", "attn", "wq"), (L, d, h, hd)),
         (("layers", "attn", "wk"), (L, d, kvh, hd)),
         (("layers", "attn", "wv"), (L, d, kvh, hd)),
         (("layers", "attn", "wo"), (L, h, hd, d)),
         (("layers", "ffn", "w_up"), (L, d, f)),
         (("layers", "ffn", "w_down"), (L, f, d))]
    if cfg["ffn_kind"] == "swiglu":
        w.append((("layers", "ffn", "w_gate"), (L, d, f)))
    n = [(("final_norm", "scale"), (d,)), (("layers", "norm1", "scale"), (L, d)),
         (("layers", "norm2", "scale"), (L, d))]
    b = []
    if cfg.get("qkv_bias"):
        b = [(("layers", "attn", "bq"), (L, h, hd)),
             (("layers", "attn", "bk"), (L, kvh, hd)),
             (("layers", "attn", "bv"), (L, kvh, hd))]
    if cfg["norm_kind"] == "layernorm":
        b += [(("final_norm", "bias"), (d,)), (("layers", "norm1", "bias"), (L, d)),
              (("layers", "norm2", "bias"), (L, d))]
    return w, n, b


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
    for group, mean, std in zip(shapes(cfg), (0.0, 1.0, 0.0), (0.02, 0.1, 0.02)):
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

