"""Parameters for the PyTorch model: converted from the JAX pytree, or drawn
on the device.

The parameter tree keeps the reference's key names and the stacked-layer
layout ``[L, ...]``::

    {"embed": [V, d], "final_norm": {"scale": [d]}, "lm_head": [d, V],
     "layers": {"attn": {"wq": [L, d, H, hd], "wk"/"wv": [L, d, KVH, hd],
                         "wo": [L, H, hd, d], ("bq", "bk", "bv")},
                "norm1"/"norm2": {"scale": [L, d], ("bias")},
                "ffn": {"w_gate", "w_up": [L, d, f], "w_down": [L, f, d]}}}

moe replaces "ffn" by "moe": {"router": [L, d, E], "w_gate"/"w_up":
[L, E, d, f], "w_down": [L, E, f, d]} (+ "dense_ffn").  hybrid stacks its
Mamba2 layers as [n_super, per, ...] under "layers": {"mamba_layers":
{"mamba": {...}, "norm": {...}}} and adds the one shared block
"shared_attn", "shared_ffn", "shared_norms": {"n1", "n2"} (unstacked).

`params_from_numpy` takes that tree as nested dicts of numpy arrays (a test
turns the JAX `Model.init` pytree into one with ``jax.tree.map(np.asarray,
params)``; this module never sees JAX).  `init_params` draws the same tree
directly on the device from a `torch.Generator`, as the reference's init
does: normal(0, 0.02) weights (0.5 for the Mamba2 conv), ones for norm
scales, zeros for biases, and the Mamba2 A_log / dt_bias draws in f32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import normal_init
from repro_torch.models.transformer import require_ported, torch_dtype


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of a ported family as nested dicts of
    ``(shape, kind)`` leaves; kind is "normal" (0.02), "conv" (normal 0.5),
    "ones", "zeros", or one of the f32 Mamba2 leaves "a_log", "dt_bias",
    "ones_f32" (`init_params` draws each as the reference's init does)."""
    require_ported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads

    def norm(lead=()):
        n = {"scale": (lead + (d,), "ones")}
        if cfg.norm_kind == "layernorm":
            n["bias"] = (lead + (d,), "zeros")
        return n

    def attn(lead=()):
        a = {
            "wq": (lead + (d, h, hd), "normal"),
            "wk": (lead + (d, kvh, hd), "normal"),
            "wv": (lead + (d, kvh, hd), "normal"),
            "wo": (lead + (h, hd, d), "normal"),
        }
        if cfg.qkv_bias:
            a["bq"] = (lead + (h, hd), "zeros")
            a["bk"] = (lead + (kvh, hd), "zeros")
            a["bv"] = (lead + (kvh, hd), "zeros")
        return a

    def ffn(f, lead=()):
        fp = {"w_up": (lead + (d, f), "normal"), "w_down": (lead + (f, d), "normal")}
        if cfg.ffn_kind == "swiglu":
            fp["w_gate"] = (lead + (d, f), "normal")
        return fp

    tree: Dict[str, Any] = {
        "embed": ((cfg.vocab_size, d), "normal"),
        "final_norm": norm(),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, cfg.vocab_size), "normal")
    L = (cfg.n_layers,)
    if cfg.family == "hybrid":
        lead = (cfg.n_layers // cfg.hybrid_mamba_per_block,
                cfg.hybrid_mamba_per_block)
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        conv_dim = d_in + 2 * cfg.ssm_state
        mamba = {
            "w_in": (lead + (d, 2 * d_in + 2 * cfg.ssm_state + nh), "normal"),
            "conv_w": (lead + (cfg.ssm_conv_width, conv_dim), "conv"),
            "conv_b": (lead + (conv_dim,), "zeros"),
            "A_log": (lead + (nh,), "a_log"),
            "D": (lead + (nh,), "ones_f32"),
            "dt_bias": (lead + (nh,), "dt_bias"),
            "norm_scale": (lead + (d_in,), "ones"),
            "w_out": (lead + (d_in, d), "normal"),
        }
        tree["layers"] = {"mamba_layers": {"mamba": mamba, "norm": norm(lead)}}
        tree["shared_attn"] = attn()
        tree["shared_ffn"] = ffn(cfg.d_ff)
        tree["shared_norms"] = {"n1": norm(), "n2": norm()}
        return tree
    layer = {"attn": attn(L), "norm1": norm(L), "norm2": norm(L)}
    if cfg.family == "moe":
        e, f = cfg.n_experts, cfg.d_ff
        layer["moe"] = {
            "router": (L + (d, e), "normal"),
            "w_up": (L + (e, d, f), "normal"),
            "w_down": (L + (e, f, d), "normal"),
        }
        if cfg.ffn_kind == "swiglu":
            layer["moe"]["w_gate"] = (L + (e, d, f), "normal")
        if cfg.dense_ff:
            layer["dense_ffn"] = ffn(cfg.dense_ff, L)
    else:
        layer["ffn"] = ffn(cfg.d_ff, L)
    tree["layers"] = layer
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

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
            lo, hi, generator=generator)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, kind = spec
        if kind in ("normal", "conv"):
            return normal_init(shape, dt, generator, dev,
                               scale=0.5 if kind == "conv" else 0.02)
        if kind == "a_log":  # A = -exp(A_log) with -A ~ U(1, 16)
            return uniform(shape, 1.0, 16.0).log()
        if kind == "dt_bias":  # inverse softplus of dt ~ U(1e-3, 0.1)
            return torch.log(torch.expm1(uniform(shape, 1e-3, 0.1)))
        if kind == "ones_f32":
            return torch.ones(shape, dtype=torch.float32, device=dev)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=dt, device=dev)

    return make(param_shapes(cfg))
