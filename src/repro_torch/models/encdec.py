"""Whisper-style encoder-decoder (the audio family): the PyTorch counterpart
of `repro/models/encdec.py`.

The conv/audio frontend is a stub, as in the reference: ``batch["frames"]``
carries precomputed frame embeddings [B, encoder_seq, d_model].  Encoder =
bidirectional attention stack; decoder = causal self-attention (KV-cached,
placed by the engine) + cross-attention over the encoder output (static KV).

Only the decoder's self-attention goes through `attn_impl`: with the default
impl, K4 for prefill and K5 for the decode history.  The encoder's attention
and the cross-attention are plain `attention.full_attention`, as the
reference computes them outside any kernel.  ``remat`` recomputes each
encoder and decoder layer in the backward, where the reference wraps both
scan bodies in ``jax.checkpoint``; ``constrain`` is the sharding-hint hook
(the identity without a mesh).  On a mesh (DTensors) the encoder runs
batch-sharded through ``enc_act``, its output is replicated over "data"
(``enc_out``), the decoder's self-attention is the mesh impl's (the ESP
ring / multi-master decode, or `ShardedAttnImpl` in training) and the
encoder and cross attention stay plain attention, per shard
(`_plain_attention`), as the reference leaves them to the SPMD
partitioner.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import (
    Cache,
    DefaultAttnImpl,
    _id_constrain,
    _last_position,
    _lead,
    layer_params,
    maybe_remat,
    torch_dtype,
)


def _plain_attention(q, k, v):
    """Non-causal attention without a mask (the encoder's self-attention
    and the cross-attention): `attention.full_attention`.  Over DTensors it
    runs per shard in a `local_map` body, as the reference leaves it to the
    SPMD partitioner: each rank's (batch, q-head) block attends to the whole
    key sequence of its KV heads (a sequence-split q sees the keys
    gathered), and the output keeps q's layout.  The einsums' flattens of a
    head- or sequence-split dim have no sharding rule in some torch
    releases, so they never see a DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return attn.full_attention(q, k, v, causal=False)
    mesh = q.device_mesh
    q_pl, kv_pl, grad_pl = [], [], []
    for i, p in enumerate(q.placements):
        if p.is_shard(0) or (p.is_shard(2) and k.shape[2] % mesh.size(i) == 0):
            q_pl.append(p)  # batch, or heads the KV heads follow
            kv_pl.append(p)
            grad_pl.append(p)
        elif p.is_shard(1):  # q rows split: every key on every rank
            q_pl.append(p)
            kv_pl.append(Replicate())
            grad_pl.append(Partial())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            grad_pl.append(Replicate())
    q_pl, kv_pl, grad_pl = tuple(q_pl), tuple(kv_pl), tuple(grad_pl)
    k, v = (x if isinstance(x, DTensor) else
            DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for x in (k, v))
    fn = local_map(lambda qb, kb, vb: attn.full_attention(qb, kb, vb, causal=False),
                   out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, grad_pl, grad_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)


class EncDecModel(nn.Module):
    """Holds no tensors itself: the parameter tree (`repro_torch.convert`)
    is an explicit argument of every entry point."""

    def __init__(self, cfg: ModelConfig, attn_impl=None, constrain=None,
                 remat: bool = False, device="cuda"):
        super().__init__()
        assert cfg.is_encoder_decoder
        from repro_torch.device import resolve_device

        self.cfg = cfg
        self.attn_impl = attn_impl or DefaultAttnImpl()
        self.constrain = constrain or _id_constrain
        self.remat = remat
        self.dtype = torch_dtype(cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------- attention
    def _proj(self, x, w):
        """[B,T,d] x [d,H,hd] -> [B,T,H,hd]."""
        return layers.dense(x, w.reshape(w.shape[0], -1)).view(
            x.shape[0], x.shape[1], w.shape[1], w.shape[2])

    def _out(self, o, w):
        """[B,T,H,hd] x [H,hd,d] -> [B,T,d]."""
        return layers.dense(o.reshape(o.shape[0], o.shape[1], -1),
                            w.reshape(-1, w.shape[-1]))

    def _qkv(self, p, xq, xkv):
        c = self.constrain
        return (c(self._proj(xq, p["wq"]), "q"), c(self._proj(xkv, p["wk"]), "kv"),
                c(self._proj(xkv, p["wv"]), "kv"))

    # --------------------------------------------------------------- encoder
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = frames.to(self.dtype)
        x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model,
                                            device=x.device).to(self.dtype)
        x = self.constrain(x, "enc_act")
        enc = params["enc_layers"]
        for li in range(_lead(enc)):
            x = maybe_remat(self.remat, self._enc_layer, layer_params(enc, li), x)
        return layers.apply_norm(params["enc_norm"], x, cfg.norm_kind,
                                 cfg.norm_eps)

    def _enc_layer(self, lp, x):
        cfg = self.cfg
        h = layers.apply_norm(lp["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        q, k, v = self._qkv(lp["attn"], h, h)
        o = _plain_attention(q, k, v)
        x = x + self._out(o, lp["attn"]["wo"])
        h = layers.apply_norm(lp["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        return self.constrain(x + layers.apply_ffn(lp["ffn"], h, cfg.ffn_kind),
                              "enc_act")

    # --------------------------------------------------------------- decoder
    def _decoder_stack(self, params, x, enc_out, positions, *, k_caches=None,
                       v_caches=None, cross_k=None, cross_v=None,
                       cache_len=None, decode=False):
        """Returns (x, (k, v) self-attention KV stacked [L, B, T, KVH, D],
        (cross_k, cross_v) stacked likewise — None on decode).  On decode
        `cache_len` is [B]."""
        dec = params["dec_layers"]
        ks, vs, cks, cvs = [], [], [], []
        for li in range(_lead(dec)):
            lp = layer_params(dec, li)
            if decode:
                x, (k, v), _ = self._dec_layer(
                    lp, x, None, None, kc=k_caches[li], vc=v_caches[li],
                    ck=cross_k[li], cv=cross_v[li], cache_len=cache_len,
                    decode=True)
            else:
                x, (k, v), (ck, cv) = maybe_remat(self.remat, self._dec_layer,
                                                  lp, x, enc_out, positions)
                cks.append(ck)
                cvs.append(cv)
            ks.append(k)
            vs.append(v)
        kvs = (torch.stack(ks), torch.stack(vs))
        if decode:
            return x, kvs, None
        return x, kvs, (torch.stack(cks), torch.stack(cvs))

    def _dec_layer(self, lp, x, enc_out, positions, *, kc=None, vc=None,
                   ck=None, cv=None, cache_len=None, decode=False):
        """One decoder layer: returns (x, self-attention (k, v), the
        cross-attention (k, v) over the encoder output, or (ck, cv) as given
        on decode)."""
        cfg = self.cfg
        h = layers.apply_norm(lp["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        q, k, v = self._qkv(lp["self_attn"], h, h)
        if decode:
            o = self.attn_impl.decode_attn(q, kc, vc, k, v, cache_len,
                                           window=None, softcap=None)
        else:
            o = self.attn_impl.prefill_attn(q, k, v, positions, positions,
                                            causal=True, window=None,
                                            softcap=None)
        x = self.constrain(x + self._out(o, lp["self_attn"]["wo"]), "act")
        # cross attention over the static encoder KV
        h = layers.apply_norm(lp["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        if decode:
            q = self._proj(h, lp["cross_attn"]["wq"])
        else:
            q, ck, cv = self._qkv(lp["cross_attn"], h, enc_out)
        o = _plain_attention(q, ck, cv)
        x = self.constrain(x + self._out(o, lp["cross_attn"]["wo"]), "act")
        h = layers.apply_norm(lp["norm3"], x, cfg.norm_kind, cfg.norm_eps)
        x = self.constrain(x + layers.apply_ffn(lp["ffn"], h, cfg.ffn_kind), "act")
        return x, (k, v), (ck, cv)

    def _embed_tokens(self, params, tokens, positions):
        x = layers.embed_lookup(params["embed"], tokens).to(self.dtype)
        # F.embedding, not an index: its gradient has a sharding rule
        pe = layers.embed_lookup(params["pos_embed"], positions).to(self.dtype)
        if pe.ndim == 2:
            pe = pe[None]
        return self.constrain(x + pe, "act")

    def _final(self, params, x):
        return layers.apply_norm(params["final_norm"], x, self.cfg.norm_kind,
                                 self.cfg.norm_eps)

    # ---------------------------------------------------------------- public
    def hidden(self, params, batch, positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-normed decoder hidden states [B,T,d] and a zero aux loss."""
        enc_out = self.constrain(self.encode(params, batch["frames"]), "enc_out")
        tokens = batch["tokens"]
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed_tokens(params, tokens, positions)
        x, _, _ = self._decoder_stack(params, x, enc_out, positions)
        return self._final(params, x), torch.zeros((), device=x.device)

    def unembed(self, params, x):
        return self.constrain(layers.lm_head_logits(x, params["lm_head"]), "logits")

    def forward(self, params, batch, positions=None):
        """Teacher-forced forward. batch: {frames, tokens}.  Returns
        (logits [B,T,V], aux loss 0)."""
        x, aux = self.hidden(params, batch, positions)
        return self.unembed(params, x), aux

    def prefill(self, params, batch, positions=None, *,
                last_logit_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        enc_out = self.constrain(self.encode(params, batch["frames"]), "enc_out")
        tokens = batch["tokens"]
        b, t = tokens.shape
        if positions is None:
            positions = torch.arange(t, device=tokens.device)
        x = self._embed_tokens(params, tokens, positions)
        x, (k, v), (ck, cv) = self._decoder_stack(params, x, enc_out, positions)
        x = self._final(params, x)
        if last_logit_only:
            x = _last_position(x, positions)
        cache = Cache(k=k, v=v,
                      length=torch.full((b,), t, dtype=torch.int32,
                                        device=x.device),
                      cross_k=ck, cross_v=cv)
        return self.unembed(params, x), cache

    def decode(self, params, tokens, cache: Cache):
        """One decode step over the padded self-attention cache; returns
        (logits [B,V], cache with length+1, per-layer new KV (k, v) each
        [L,B,1,KVH,D]) — the caller places the new KV, as for `Model`."""
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        b = tokens.shape[0]
        cl = torch.as_tensor(cache.length, device=tokens.device).expand(b)
        x = self._embed_tokens(params, tokens, cl[:, None].long())
        x, kvs, _ = self._decoder_stack(
            params, x, None, None, k_caches=cache.k, v_caches=cache.v,
            cross_k=cache.cross_k, cross_v=cache.cross_v, cache_len=cl,
            decode=True,
        )
        logits = self.unembed(params, self._final(params, x))[:, 0]
        return logits, cache._replace(length=cache.length + 1), kvs

