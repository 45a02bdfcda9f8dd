"""Parameters for the PyTorch models: converted from the JAX pytree, or drawn
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
ssm (xLSTM) stacks twice: "layers": {"mlstm_layers": {"cell", "norm"}} with
leaves [n_super, m_per, ...] and "layers": {"slstm": {"cell", "norm"}} with
leaves [n_super, ...].  The encoder-decoder (whisper) has "embed",
"pos_embed" [max_seq_len, d], "enc_layers" {"attn", "norm1", "ffn",
"norm2"} [L_enc, ...], "dec_layers" {"self_attn", "cross_attn", "norm1"-
"norm3", "ffn"} [L, ...], "enc_norm", "final_norm" and "lm_head".

`params_from_numpy` takes that tree as nested dicts of numpy arrays (a test
turns the JAX `init` pytree into one with ``jax.tree.map(np.asarray,
params)``; this module never sees JAX); `opt_state_from_numpy` does the same
for the AdamW state ``{"m", "v", "step"}``, and `params_to_numpy` /
`opt_state_to_numpy` are their inverses — together the reference train
CLI's pickled checkpoint layout.  `init_params` draws the same tree
directly on the device from a `torch.Generator`, as the reference's init
does: normal(0, 0.02) weights (0.5 for the Mamba2 conv, 0.01 for whisper's
``pos_embed``, 0.1 for the mLSTM gate projection ``w_if``, 0.05 for the
sLSTM recurrence ``r_zifo``), ones for norm scales, zeros for biases, the
Mamba2 A_log / dt_bias draws in f32, and the xLSTM gate biases in f32
(forget bias 3.0, the others 0).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import normal_init
from repro_torch.models.transformer import torch_dtype, xlstm_layout

# std of each normal init kind, and the value of each constant f32 kind
_NORMAL = {"normal": 0.02, "conv": 0.5, "pos_embed": 0.01, "w_if": 0.1,
           "r_zifo": 0.05}
_F32_FILL = {"ones_f32": 1.0, "zeros_f32": 0.0, "forget_bias": 3.0}


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of a config as nested dicts of ``(shape, kind)``
    leaves; kind is a normal draw (`_NORMAL`: "normal" 0.02, "conv",
    "pos_embed", "w_if", "r_zifo"), "ones", "zeros", an f32 constant
    (`_F32_FILL`: "ones_f32", "zeros_f32", "forget_bias") or one of the f32
    Mamba2 draws "a_log", "dt_bias" (`init_params` draws each as the
    reference's init does)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads

    def norm(lead=()):
        n = {"scale": (lead + (d,), "ones")}
        if cfg.norm_kind == "layernorm":
            n["bias"] = (lead + (d,), "zeros")
        return n

    def attn(lead=(), bias=cfg.qkv_bias):
        a = {
            "wq": (lead + (d, h, hd), "normal"),
            "wk": (lead + (d, kvh, hd), "normal"),
            "wv": (lead + (d, kvh, hd), "normal"),
            "wo": (lead + (h, hd, d), "normal"),
        }
        if bias:
            a["bq"] = (lead + (h, hd), "zeros")
            a["bk"] = (lead + (kvh, hd), "zeros")
            a["bv"] = (lead + (kvh, hd), "zeros")
        return a

    def ffn(f, lead=()):
        fp = {"w_up": (lead + (d, f), "normal"), "w_down": (lead + (f, d), "normal")}
        if cfg.ffn_kind == "swiglu":
            fp["w_gate"] = (lead + (d, f), "normal")
        return fp

    if cfg.is_encoder_decoder:
        le, ld = (cfg.n_encoder_layers,), (cfg.n_layers,)
        return {
            "embed": ((cfg.vocab_size, d), "normal"),
            "pos_embed": ((cfg.max_seq_len, d), "pos_embed"),
            "enc_layers": {"attn": attn(le, False), "norm1": norm(le),
                           "ffn": ffn(cfg.d_ff, le), "norm2": norm(le)},
            "dec_layers": {"self_attn": attn(ld, False),
                           "cross_attn": attn(ld, False), "norm1": norm(ld),
                           "norm2": norm(ld), "norm3": norm(ld),
                           "ffn": ffn(cfg.d_ff, ld)},
            "enc_norm": norm(),
            "final_norm": norm(),
            "lm_head": ((d, cfg.vocab_size), "normal"),
        }
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
    if cfg.family == "ssm":
        n_super, m_per = xlstm_layout(cfg)
        sl, ml = (n_super,), (n_super, m_per)
        d_in = int(cfg.xlstm_proj_factor * d)
        dh = d_in // h
        mlstm = {
            "w_up": (ml + (d, 2 * d_in), "normal"),
            "w_q": (ml + (d_in, d_in), "normal"),
            "w_k": (ml + (d_in, d_in), "normal"),
            "w_v": (ml + (d_in, d_in), "normal"),
            "w_o": (ml + (d_in, d_in), "normal"),
            "w_if": (ml + (d_in, 2 * h), "w_if"),
            "b_i": (ml + (h,), "zeros_f32"),
            "b_f": (ml + (h,), "forget_bias"),
            "w_down": (ml + (d_in, d), "normal"),
        }
        slstm = {
            "w_up": (sl + (d, 2 * d_in), "normal"),
            "w_zifo": (sl + (d_in, 4 * d_in), "normal"),
            "r_zifo": (sl + (4, h, dh, dh), "r_zifo"),
            "b_zifo": (sl + (4 * d_in,), "zeros_f32"),
            "w_down": (sl + (d_in, d), "normal"),
        }
        tree["layers"] = {
            "mlstm_layers": {"cell": mlstm, "norm": norm(ml)},
            "slstm": {"cell": slstm, "norm": norm(sl)},
        }
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


def opt_state_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                         device="cuda") -> Dict[str, Any]:
    """Load the reference's AdamW state ``{"m", "v", "step"}`` (moments
    shaped like the parameters, f32; step an int32 scalar) onto `device`."""
    dev = resolve_device(device)
    return {"m": params_from_numpy(cfg, tree["m"], dev),
            "v": params_from_numpy(cfg, tree["v"], dev),
            "step": torch.as_tensor(np.asarray(tree["step"], np.int32),
                                    device=dev)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: ml_dtypes', as JAX's
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree as nested dicts of numpy arrays (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _to_numpy(tree)


def opt_state_to_numpy(opt: Dict[str, Any]) -> Dict[str, Any]:
    """The AdamW state as the reference pickles it: nested numpy moments and
    an int32 scalar step."""
    return {"m": params_to_numpy(opt["m"]), "v": params_to_numpy(opt["v"]),
            "step": np.asarray(_to_numpy(opt["step"]), np.int32)}


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
        if kind in _NORMAL:
            return normal_init(shape, dt, generator, dev, scale=_NORMAL[kind])
        if kind == "a_log":  # A = -exp(A_log) with -A ~ U(1, 16)
            return uniform(shape, 1.0, 16.0).log()
        if kind == "dt_bias":  # inverse softplus of dt ~ U(1e-3, 0.1)
            return torch.log(torch.expm1(uniform(shape, 1e-3, 0.1)))
        if kind in _F32_FILL:
            return torch.full(shape, _F32_FILL[kind], dtype=torch.float32,
                              device=dev)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=dt, device=dev)

    return make(param_shapes(cfg))
