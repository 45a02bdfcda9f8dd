"""Parameters for the PyTorch model: converted from the JAX pytree, or drawn
on the device.

The parameter tree keeps the reference's key names and the stacked-layer
layout ``[L, ...]``::

    {"embed": [V, d], "final_norm": {"scale": [d]}, "lm_head": [d, V],
     "layers": {"attn": {"wq": [L, d, H, hd], "wk"/"wv": [L, d, KVH, hd],
                         "wo": [L, H, hd, d], ("bq", "bk", "bv")},
                "norm1"/"norm2": {"scale": [L, d], ("bias")},
                "ffn": {"w_gate", "w_up": [L, d, f], "w_down": [L, f, d]}}}

`params_from_numpy` takes that tree as nested dicts of numpy arrays (a test
turns the JAX `Model.init` pytree into one with ``jax.tree.map(np.asarray,
params)``; this module never sees JAX).  `init_params` draws the same tree
directly on the device from a `torch.Generator`, as `layers.normal_init`
does in the reference: normal(0, 0.02) weights, ones for norm scales and
zeros for biases.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import normal_init
from repro_torch.models.transformer import torch_dtype


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The dense-family parameter tree as nested dicts of
    ``(shape, kind)`` leaves, kind in {"normal", "ones", "zeros"}."""
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet "
            "(ROADMAP queue 1 item 11)"
        )
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    h, kvh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def norm(prefix=()):
        n = {"scale": (prefix + (d,), "ones")}
        if cfg.norm_kind == "layernorm":
            n["bias"] = (prefix + (d,), "zeros")
        return n

    attn = {
        "wq": ((L, d, h, hd), "normal"),
        "wk": ((L, d, kvh, hd), "normal"),
        "wv": ((L, d, kvh, hd), "normal"),
        "wo": ((L, h, hd, d), "normal"),
    }
    if cfg.qkv_bias:
        attn["bq"] = ((L, h, hd), "zeros")
        attn["bk"] = ((L, kvh, hd), "zeros")
        attn["bv"] = ((L, kvh, hd), "zeros")
    ffn = {"w_up": ((L, d, f), "normal"), "w_down": ((L, f, d), "normal")}
    if cfg.ffn_kind == "swiglu":
        ffn["w_gate"] = ((L, d, f), "normal")
    tree: Dict[str, Any] = {
        "embed": ((cfg.vocab_size, d), "normal"),
        "final_norm": norm(),
        "layers": {"attn": attn, "norm1": norm((L,)), "norm2": norm((L,)),
                   "ffn": ffn},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, cfg.vocab_size), "normal")
    return tree


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # arrays read from JAX buffers are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device, copy=True)
    return torch.from_numpy(a).to(device, copy=True)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> Dict[str, Any]:
    """Load the JAX `Model.init` pytree (nested dicts of numpy arrays) as
    the port's parameter tree on `device`.  Keys and shapes are checked
    against `param_shapes(cfg)`; dtypes are kept."""
    dev = resolve_device(device)

    def conv(spec, sub, path):
        if set(spec) != set(sub):
            raise KeyError(f"{path or 'params'}: keys {sorted(sub)} != "
                           f"expected {sorted(spec)}")
        out = {}
        for k, s in spec.items():
            if isinstance(s, dict):
                out[k] = conv(s, sub[k], f"{path}/{k}")
                continue
            a = np.asarray(sub[k])
            if tuple(a.shape) != tuple(s[0]):
                raise ValueError(f"{path}/{k}: shape {a.shape} != {s[0]}")
            out[k] = _to_tensor(a, dev)
        return out

    return conv(param_shapes(cfg), tree, "")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn directly on `device` in ``cfg.dtype``
    (`generator` must live on that device)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, kind = spec
        if kind == "normal":
            return normal_init(shape, dt, generator, dev)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=dt, device=dev)

    return make(param_shapes(cfg))
