"""Dense / vlm transformer: the PyTorch counterpart of
`repro/models/transformer.py` for the families the serving path batches.

Parameters stay a nested dict of tensors with the reference's key names and
the stacked-layer layout ``[L, ...]`` (see `repro_torch.convert`), and every
entry point takes them explicitly, as the reference does — so one parameter
set converted from the JAX pytree drives both packages in the parity tests.

  * Attention is pluggable (`attn_impl`): the default is dense local math;
    the packed-prefill / striped-ring / multi-master paged-decode impls from
    `repro_torch.core` plug in here.
  * `positions` is an explicit input everywhere, so the striped permutation
    is transparent to the model (RoPE and masks are position-based).
  * The reference's `lax.scan` over stacked layers is a Python loop over
    layer slices (views — no copy).

Other families (moe, hybrid, ssm, encoder-decoder) raise NotImplementedError:
they are ROADMAP queue 1 item 11.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def layer_params(stacked: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer `li`'s parameters: the stacked ``[L, ...]`` tree indexed at
    its leading axis (views)."""
    return {
        k: layer_params(v, li) if isinstance(v, dict) else v[li]
        for k, v in stacked.items()
    }


def _n_layers(params) -> int:
    leaf = params["layers"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(leaf.shape[0])


class DefaultAttnImpl:
    """Plain (single-group) attention implementation."""

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        return attn.full_attention(
            q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
            softcap=softcap,
        )

    def decode_attn(self, q, k_cache, v_cache, k_new, v_new, cache_len, *,
                    window, softcap):
        """q [B,1,H,D]; cache [B,S,KVH,D]; new token's kv [B,1,KVH,D] kept
        out of the cache (it lives at the master instance under ESP)."""
        b, s = k_cache.shape[0], k_cache.shape[1]
        pos = torch.arange(s, device=q.device)
        cl = torch.as_tensor(cache_len, device=q.device).expand(b)
        k_valid = pos[None, :] < cl[:, None]
        q_pos = cl[:, None]
        mask = attn.mask_from_positions(
            q_pos, pos.expand(b, s), causal=True, window=window,
            k_valid=k_valid,
        )
        p_hist = attn.partial_attention(q, k_cache, v_cache, mask, softcap=softcap)
        p_new = attn.partial_attention(q, k_new, v_new, None, softcap=softcap)
        out = attn.finalize_partial(attn.merge_partial(p_hist, p_new))
        return out.to(q.dtype)


class Cache(NamedTuple):
    """KV state for decode. Fields unused by a caller are None."""

    k: Optional[torch.Tensor] = None  # [L,B,S,KVH,Dh]
    v: Optional[torch.Tensor] = None
    length: Optional[torch.Tensor] = None  # [B] valid token count


class Model(nn.Module):
    """Dense-family decoder.  Holds no tensors itself: the parameter tree is
    an explicit argument of every entry point, as in the reference."""

    def __init__(self, cfg: ModelConfig, attn_impl=None, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "vlm") or cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to PyTorch yet "
                "(ROADMAP queue 1 item 11)"
            )
        from repro_torch.device import resolve_device

        self.cfg = cfg
        self.attn_impl = attn_impl or DefaultAttnImpl()
        self.dtype = torch_dtype(cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------ embedding
    def embed_inputs(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: {"tokens": [B,T]} (+ "patch_embeds": [B,Ti,d] for vlm)."""
        x = layers.embed_lookup(params["embed"], batch["tokens"]).to(self.dtype)
        if self.cfg.frontend == "patch_stub" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(self.dtype)
            x = torch.cat([pe, x], dim=1)  # image tokens first
        return x

    def unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return layers.lm_head_logits(x, w)

    # -------------------------------------------------------------- qkv math
    def _qkv(self, p, x, positions):
        cfg = self.cfg
        b, t, d = x.shape
        hd = cfg.head_dim
        q = (x @ p["wq"].reshape(d, -1)).view(b, t, cfg.n_heads, hd)
        k = (x @ p["wk"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
        v = (x @ p["wv"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        if cfg.rope_theta:
            d_rot = int(hd * cfg.rope_fraction) // 2 * 2
            cos, sin = layers.rope_cos_sin(positions, d_rot, cfg.rope_theta)
            q = layers.apply_rope(q, cos, sin, d_rot)
            k = layers.apply_rope(k, cos, sin, d_rot)
        return q, k, v

    def _out_proj(self, p, out):
        b, t = out.shape[0], out.shape[1]
        return out.reshape(b, t, -1) @ p["wo"].reshape(-1, self.cfg.d_model)

    def _attn_block_prefill(self, p, x, positions):
        cfg = self.cfg
        q, k, v = self._qkv(p, x, positions)
        out = self.attn_impl.prefill_attn(
            q, k, v, positions, positions, causal=True,
            window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
        )
        return self._out_proj(p, out), (k, v)

    def _attn_block_decode(self, p, x, k_cache, v_cache, cache_len):
        cfg = self.cfg
        b = x.shape[0]
        cl = torch.as_tensor(cache_len, device=x.device).expand(b)
        q, k_new, v_new = self._qkv(p, x, cl[:, None])
        out = self.attn_impl.decode_attn(
            q, k_cache, v_cache, k_new, v_new, cl,
            window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
        )
        return self._out_proj(p, out), (k_new, v_new)

    # ====================================================== dense stack
    def _dense_stack(self, params, x, positions, *, k_caches=None,
                     v_caches=None, cache_len=None, decode=False):
        """Python loop over the stacked layers; returns (x, (k, v)) with the
        per-layer KV stacked on a leading [L] axis."""
        cfg = self.cfg
        ks, vs = [], []
        for li in range(_n_layers(params)):
            lp = layer_params(params["layers"], li)
            h = layers.apply_norm(lp["norm1"], x, cfg.norm_kind, cfg.norm_eps)
            if decode:
                kc = k_caches[li] if k_caches is not None else None
                vc = v_caches[li] if v_caches is not None else None
                y, (k, v) = self._attn_block_decode(lp["attn"], h, kc, vc, cache_len)
            else:
                y, (k, v) = self._attn_block_prefill(lp["attn"], h, positions)
            x = x + y
            h = layers.apply_norm(lp["norm2"], x, cfg.norm_kind, cfg.norm_eps)
            x = x + layers.apply_ffn(lp["ffn"], h, cfg.ffn_kind)
            ks.append(k)
            vs.append(v)
        return x, (torch.stack(ks), torch.stack(vs))

    # ============================================================== public
    def prefill(self, params, batch, positions=None, *,
                last_logit_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Prefill: logits (+ populated cache).  With last_logit_only=True
        only the final *global* position (max of `positions`) is unembedded."""
        x = self.embed_inputs(params, batch)
        b, t = x.shape[0], x.shape[1]
        if positions is None:
            positions = torch.arange(t, device=x.device)
        x, (k, v) = self._dense_stack(params, x, positions)
        cache = Cache(k=k, v=v, length=torch.full((b,), t, dtype=torch.int32,
                                                  device=x.device))
        if last_logit_only:
            pos = torch.as_tensor(positions, device=x.device).expand(t)
            x = x[:, int(torch.argmax(pos))][:, None, :]
        return self.unembed(params, x), cache

    def prefill_packed_hidden(
        self, params, batch, positions
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The stack half of `prefill_packed`: embed + dense stack over the
        packed token axis — (x [1, T, d], (k, v) packed per-layer KV
        [L, T, KVH, D])."""
        x = self.embed_inputs(params, batch)  # [1, T, d]
        x, (k, v) = self._dense_stack(params, x, positions)  # [L, 1, T, ...]
        return x, (k[:, 0], v[:, 0])

    def prefill_packed(
        self, params, batch, positions, last_idx
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Packed ragged prefill: a whole batch of prompts concatenated on
        ONE token axis (batch dim 1).  `positions` are per-token LOCAL
        positions (RoPE/window stay per-request correct) and the armed
        attention impl (core.paged_prefill.PackedPrefillAttnImpl) applies
        the segment mask.  `last_idx` [B] selects each request's final packed
        token; only those rows are unembedded.  Returns (logits [B, V],
        (k, v) packed per-layer KV [L, T, KVH, D]) — the KV that
        `kvcache.pool.fill_packed` scatters into paged device storage."""
        x, kv = self.prefill_packed_hidden(params, batch, positions)
        sel = x[0].index_select(0, torch.as_tensor(last_idx, dtype=torch.long,
                                                   device=x.device))
        logits = self.unembed(params, sel[None])[0]  # [B, V]
        return logits, kv

    def decode(self, params, tokens, cache: Cache):
        """One decode step. tokens [B] or [B,1].  Returns (logits [B,V],
        cache with length+1, per-layer new KV (k, v) each [L,B,1,KVH,D]);
        cache.k/v are NOT updated here — the engine / KV pool owns
        placement (LoongServe semantics)."""
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        x = layers.embed_lookup(params["embed"], tokens).to(self.dtype)
        cl = cache.length
        x, kvs = self._dense_stack(
            params, x, None, k_caches=cache.k, v_caches=cache.v,
            cache_len=cl, decode=True,
        )
        new_cache = Cache(k=cache.k, v=cache.v, length=cl + 1)
        logits = self.unembed(params, x)[:, 0]
        return logits, new_cache, kvs
