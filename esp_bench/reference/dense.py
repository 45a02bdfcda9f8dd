"""Plain PyTorch reference of the dense family as the configuration file
states it: embedding, per layer RMSNorm -> q/k/v products (+ qkv bias)
-> rotary on the first ``rope_fraction`` of each head (the half-split
pair layout) -> causal softmax attention with grouped KV heads -> output
product -> residual -> RMSNorm -> SwiGLU (or GELU / ReLU^2) FFN ->
residual, then the final norm and the unembedding.

Everything is float32 with TF32 off, whatever type the weights are
stored in; attention runs in blocks of queries and the FFN in blocks of
rows, so a 64k-token prompt fits beside the weights on one card.  It
imports nothing of the program and takes only the benchmark's own
weights and token ids.

``shapes(cfg)`` lists the family's weight tree, which
`esp_bench/weights.py` draws for the port and for this reference alike.

``lowp="fp8"`` is the control: every product's operands (activations
per row, weights per tensor) and the attention's q, k, v rounded to
float8 e4m3 with a scale, the step below the served bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """x rounded through float8 e4m3 with an absmax scale (per row along
    `dim`, or per tensor for dim None), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Ops:
    def __init__(self, lowp: Optional[str]):
        assert lowp in (None, "fp8"), lowp
        self.lowp = lowp

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.lowp:
            return _fp8(a, -1) @ _fp8(w, None)
        return a @ w

    def qkv(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t, -1) if self.lowp else t


def _norm(x, scale, bias, kind, eps):
    if kind == "rmsnorm":
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    else:
        mu = x.mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + eps)
    y = y * scale.float()
    return y + bias.float() if bias is not None else y


def _rope(x, cos, sin, d_rot):
    """x [S, H, D]: rotate the first d_rot features, halves paired."""
    if d_rot == 0:
        return x
    h = d_rot // 2
    x1, x2, rest = x[..., :h], x[..., h:d_rot], x[..., d_rot:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def _ffn(ops, w, h, kind):
    up = ops.mm(h, w["w_up"])
    if kind == "swiglu":
        a = F.silu(ops.mm(h, w["w_gate"])) * up
    elif kind == "gelu":
        a = F.gelu(up, approximate="tanh")
    else:  # relu2
        a = F.relu(up).square()
    return ops.mm(a, w["w_down"])


def _attention(ops, q, k, v, q_block):
    """Causal attention of q [S, H, D] over k, v [S, KVH, D] -> [S, H*D]."""
    s_len, h, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(1, 2, 0)  # [KVH, D, S]
    vv = v.permute(1, 0, 2)  # [KVH, S, D]
    out = torch.empty(s_len, h * d, dtype=torch.float32, device=q.device)
    for qs in range(0, s_len, q_block):
        qe = min(s_len, qs + q_block)
        n = qe - qs
        qb = q[qs:qe].view(n, kvh, g, d).permute(1, 2, 0, 3).reshape(kvh, g * n, d)
        sc = (qb @ kt[:, :, :qe]) * scale  # [KVH, g*n, qe]
        sc = sc.view(kvh, g, n, qe)
        qpos = torch.arange(qs, qe, device=q.device)[:, None]
        kpos = torch.arange(qe, device=q.device)[None, :]
        sc.masked_fill_(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1).view(kvh, g * n, qe)
        o = (p @ vv[:, :qe]).view(kvh, g, n, d).permute(2, 0, 1, 3)
        out[qs:qe] = o.reshape(n, h * d)
    return out


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


@torch.no_grad()
def logits_at(cfg: Dict, params: Dict, tokens: torch.Tensor,
              rows: torch.Tensor, *, lowp: Optional[str] = None,
              q_block: int = 512, row_block: int = 8192) -> torch.Tensor:
    """float32 logits [len(rows), V] of the causal LM over `tokens` [S]
    (int64, on the weights' device) at positions `rows`."""
    assert cfg.get("sliding_window") is None and cfg.get("attn_logit_softcap") is None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = _Ops(lowp)
    d, hd = cfg["d_model"], cfg["d_head"]
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    kind, eps = cfg["norm_kind"], cfg["norm_eps"]
    lp = params["layers"]
    s_len = tokens.shape[0]
    x = params["embed"][tokens].float()  # [S, d]
    d_rot = int(hd * cfg["rope_fraction"]) // 2 * 2 if cfg["rope_theta"] else 0
    if d_rot:
        inv = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, d_rot, 2, dtype=torch.float32, device=x.device) / d_rot))
        ang = torch.arange(s_len, dtype=torch.float32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
    else:
        cos = sin = None
    nb = lambda grp, li: lp[grp].get("bias")[li] if "bias" in lp[grp] else None  # noqa: E731
    for li in range(cfg["n_layers"]):
        a = lp["attn"]
        hn = _norm(x, lp["norm1"]["scale"][li], nb("norm1", li), kind, eps)
        q = ops.mm(hn, a["wq"][li].float().reshape(d, h * hd)).view(s_len, h, hd)
        k = ops.mm(hn, a["wk"][li].float().reshape(d, kvh * hd)).view(s_len, kvh, hd)
        v = ops.mm(hn, a["wv"][li].float().reshape(d, kvh * hd)).view(s_len, kvh, hd)
        del hn
        if cfg.get("qkv_bias"):
            q, k, v = q + a["bq"][li].float(), k + a["bk"][li].float(), v + a["bv"][li].float()
        q, k = _rope(q, cos, sin, d_rot), _rope(k, cos, sin, d_rot)
        o = _attention(ops, ops.qkv(q), ops.qkv(k), ops.qkv(v), q_block)
        del q, k, v
        x += ops.mm(o, a["wo"][li].float().reshape(h * hd, d))
        del o
        wf = {n: t[li].float() for n, t in lp["ffn"].items()}
        for rs in range(0, s_len, row_block):
            xb = x[rs:rs + row_block]
            hb = _norm(xb, lp["norm2"]["scale"][li], nb("norm2", li), kind, eps)
            xb += _ffn(ops, wf, hb, cfg["ffn_kind"])
        del wf
    fn = params["final_norm"]
    hf = _norm(x[rows], fn["scale"], fn.get("bias"), kind, eps)
    w = params["embed"].T if cfg.get("tie_embeddings") else params["lm_head"]
    return ops.mm(hf, w.float())
