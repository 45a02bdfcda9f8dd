"""The yardstick's work counts and the table of peaks, frozen here.

They count what the traffic asks of a dense model, whatever implements
it: the products of each token through the stack, causal attention over
each prompt, and each decode row's read of its context.  Bytes are at the
model's bf16 (2 bytes), whatever the pool stores, so a share can never
read over 100 % and a narrower pool shows as a gain.

The formulas follow `src/repro_torch/launch/dryrun.py::model_flops_estimate`
and `launch/census.py::attention_flops` (commit d8ac532): 2 FLOPs per
multiply-add of every product, 4 h d FLOPs per kept (query, key) pair of
attention, n^2 / 2 pairs for a causal prompt of n tokens.  A test holds
them against the census of the port's own prefill at a tiny shape.

Another family states its own work: each public count below
(`decode_flops`, `decode_bytes`, `decode_attn_flops`, `decode_attn_bytes`,
`prefill_flops`, `prefill_attn_flops`, `prefill_attn_bytes`) is the
function of the same name and signature in the configuration's reference
module where that module defines one (`esp_bench/lookup.py`), and the
dense formula here otherwise.  A module states the four decode counts
together and the three prefill counts together, or none of a group
(`lookup.COUNTS`): a dense `decode_flops` would count every expert's FFN
beside a family's own attention.
"""
from __future__ import annotations

import functools

from esp_bench import lookup

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
BF16 = 2


def _family(dense):
    """The count `dense`, or the configuration's reference module's own
    function of that name where it defines one."""
    @functools.wraps(dense)
    def count(cfg: dict, arg) -> float:
        return getattr(lookup.reference(cfg), dense.__name__, dense)(cfg, arg)
    return count


def _ffn_mats(cfg: dict) -> int:
    return 3 if cfg["ffn_kind"] == "swiglu" else 2


def layer_weights(cfg: dict) -> int:
    """Multiply-adds of one token through one layer's products."""
    d, h, kvh, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    return d * h * hd + 2 * d * kvh * hd + h * hd * d + _ffn_mats(cfg) * d * cfg["d_ff"]


def token_flops(cfg: dict) -> float:
    """Product FLOPs of one token through every layer (no unembedding)."""
    return 2.0 * cfg["n_layers"] * layer_weights(cfg)


def unembed_flops(cfg: dict, rows: int) -> float:
    """Unembedding of `rows` sampled positions."""
    return 2.0 * cfg["d_model"] * cfg["vocab_size"] * rows


@_family
def prefill_attn_flops(cfg: dict, n: int) -> float:
    """Causal attention of one prompt of n tokens, every layer."""
    return 4.0 * cfg["n_heads"] * cfg["d_head"] * cfg["n_layers"] * n * n / 2.0


@_family
def prefill_attn_bytes(cfg: dict, n: int) -> float:
    """q, k, v and o of one prompt, each once, every layer, in bf16."""
    h, kvh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    return float(BF16 * cfg["n_layers"] * n * (2 * h * hd + 2 * kvh * hd))


@_family
def prefill_flops(cfg: dict, lens) -> float:
    """A prefill call over prompts `lens`: products, causal attention and
    one unembedded row per prompt."""
    return sum(token_flops(cfg) * n + prefill_attn_flops(cfg, n) for n in lens) \
        + unembed_flops(cfg, len(lens))


@_family
def decode_attn_flops(cfg: dict, ctx) -> float:
    """Decode rows with cached contexts `ctx`: each query against its
    ctx + 1 keys (the cached ones and its own)."""
    keys = float(sum(ctx) + len(ctx))
    return 4.0 * cfg["n_heads"] * cfg["d_head"] * cfg["n_layers"] * keys


@_family
def decode_attn_bytes(cfg: dict, ctx) -> float:
    """Each row's K and V (ctx + 1 keys) read once, plus its q and o, in
    bf16."""
    h, kvh, hd, L = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"], cfg["n_layers"]
    keys = sum(ctx) + len(ctx)
    return float(BF16 * L * (2 * kvh * hd * keys + 2 * h * hd * len(ctx)))


def weight_bytes(cfg: dict) -> float:
    """Weights a decode step reads once: every layer's products and norms,
    the final norm and the unembedding (the embedding is read by row)."""
    d, L = cfg["d_model"], cfg["n_layers"]
    h, kvh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    bias = (h + 2 * kvh) * hd if cfg.get("qkv_bias") else 0
    return float(BF16 * (L * (layer_weights(cfg) + bias + 2 * d) + d
                         + d * cfg["vocab_size"]))


@_family
def decode_flops(cfg: dict, ctx) -> float:
    """A decode call over rows with contexts `ctx`."""
    n = len(ctx)
    return token_flops(cfg) * n + decode_attn_flops(cfg, ctx) + unembed_flops(cfg, n)


@_family
def decode_bytes(cfg: dict, ctx) -> float:
    """A decode call's least traffic: weights once plus the rows' K and V."""
    return weight_bytes(cfg) + decode_attn_bytes(cfg, ctx)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
