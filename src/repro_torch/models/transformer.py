"""Decoder model: the PyTorch counterpart of `repro/models/transformer.py`
for the dense, vlm, moe, hybrid (zamba2) and ssm (xLSTM) families; the
encoder-decoder (whisper) is `models.encdec.EncDecModel`, built on the same
attention impl and `Cache`.

Parameters stay a nested dict of tensors with the reference's key names and
the stacked-layer layout ``[L, ...]`` (see `repro_torch.convert`), and every
entry point takes them explicitly, as the reference does — so one parameter
set converted from the JAX pytree drives both packages in the parity tests.

  * Attention is pluggable (`attn_impl`): the default runs the kernels K4
    (prefill) and K5 (decode history) through `kernels.ops`; the
    packed-prefill / striped-ring / multi-master paged-decode impls from
    `repro_torch.core` plug in here for the dense family.  The recurrent
    layers' prefill goes through the impl's `ssm_scan` hook, as in the
    reference.
  * `positions` is an explicit input everywhere, so the striped permutation
    is transparent to the model (RoPE and masks are position-based).
  * The reference's `lax.scan` over stacked layers is a Python loop over
    layer slices (views — no copy).
  * moe: the FFN is `models.moe.apply_moe` on the S-major flattened tokens.
  * hybrid: superblocks of `hybrid_mamba_per_block` Mamba2 layers followed
    by ONE application of the shared attention + FFN block (one parameter
    set for all superblocks); the recurrent state rides in `Cache.ssm`.
  * ssm: superblocks of ``m_per`` mLSTM blocks and one sLSTM block; no KV
    (`Cache.k` is None), the (mLSTM, sLSTM) states ride in `Cache.ssm`.
  * ``remat=True`` recomputes each layer body in the backward
    (`torch.utils.checkpoint`, non-reentrant) where the reference wraps its
    scan body in ``jax.checkpoint``: the dense layer, the hybrid superblock,
    the xLSTM superblock (not at decode).  ``constrain(tensor, tag)`` is the
    reference's sharding-hint hook at the same points; without a mesh it is
    the identity.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm, xlstm

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


def _lead(tree) -> int:
    """Leading (stacked-layer) size of a parameter tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def _n_layers(params) -> int:
    return _lead(params["layers"])


def _id_constrain(x, _tag):
    return x


def maybe_remat(remat: bool, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward when `remat` (the
    reference's ``jax.checkpoint`` around a scan body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class DefaultAttnImpl:
    """Single-group attention through the kernels: K4 for prefill, K5 for
    the decode history.  The same function as the reference's dense
    `DefaultAttnImpl`: its oracles `striped_flash_attention_ref` (literally
    `full_attention`) and `flash_decode_partial_ref` (with k_pos_offset 0
    and lengths = cache_len, the same ``kp > len - window`` predicate) are
    exactly this math (`repro/kernels/ref.py:43-65`)."""

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        return ops.attention(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, softcap=softcap)

    def decode_attn(self, q, k_cache, v_cache, k_new, v_new, cache_len, *,
                    window, softcap):
        """q [B,1,H,D]; cache [B,S,KVH,D]; new token's kv [B,1,KVH,D] kept
        out of the cache (it lives at the master instance under ESP).  The
        one-key partial of the new token, the merge and the finalize stay
        plain, as the reference computes them outside any kernel."""
        b = k_cache.shape[0]
        cl = torch.as_tensor(cache_len, device=q.device).expand(b)
        p_hist = ops.decode_partial(q, k_cache, v_cache, cl, window=window,
                                    softcap=softcap)
        p_new = attn.partial_attention(q, k_new, v_new, None, softcap=softcap)
        out = attn.finalize_partial(attn.merge_partial(p_hist, p_new))
        return out.to(q.dtype)

    def ssm_scan(self, kind, p, x, cfg, state):
        """Recurrent-layer hook (sequence parallelism adds its cross-device
        state handoff here).  kind: "mamba" | "mlstm" | "slstm"; returns
        (y, new_state)."""
        if kind == "mamba":
            return ssm.mamba2_forward(p, x, cfg, state)
        if kind == "mlstm":
            return xlstm.mlstm_block_forward(p, x, cfg, state)
        if kind == "slstm":
            return xlstm.slstm_block_forward(p, x, cfg, state)
        raise ValueError(kind)  # pragma: no cover


class Cache(NamedTuple):
    """KV / recurrent state for decode. Fields unused by a family are None."""

    k: Optional[torch.Tensor] = None  # [L,B,S,KVH,Dh]
    v: Optional[torch.Tensor] = None
    length: Optional[torch.Tensor] = None  # [B] valid token count
    # hybrid: SSMState, leaves [n_super, per, B, ...]; ssm: (MLSTMState with
    # leaves [n_super, m_per, B, ...], SLSTMState with leaves [n_super, B, ...])
    ssm: Optional[Any] = None
    cross_k: Optional[torch.Tensor] = None  # whisper cross-attention [L,B,S_enc,KVH,Dh]
    cross_v: Optional[torch.Tensor] = None


def xlstm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, m_per) of an xLSTM stack: superblocks of m_per mLSTM
    blocks and one sLSTM block."""
    every = cfg.xlstm_slstm_every or (cfg.n_layers + 1)
    n_super = max(cfg.n_layers // every, 1)
    return n_super, cfg.n_layers // n_super - 1


class Model(nn.Module):
    """Decoder of every decoder-only family.  Holds no tensors itself: the
    parameter tree is an explicit argument of every entry point, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, attn_impl=None,
                 constrain: Optional[Callable] = None, remat: bool = False,
                 device="cuda"):
        super().__init__()
        from repro_torch.device import resolve_device

        self.cfg = cfg
        self.attn_impl = attn_impl or DefaultAttnImpl()
        self.constrain = constrain or _id_constrain
        self.remat = remat
        self.dtype = torch_dtype(cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------ embedding
    def embed_inputs(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: {"tokens": [B,T]} (+ "patch_embeds": [B,Ti,d] for vlm)."""
        x = layers.embed_lookup(params["embed"], batch["tokens"]).to(self.dtype)
        if self.cfg.frontend == "patch_stub" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(self.dtype)
            x = torch.cat([pe, x], dim=1)  # image tokens first
        return self.constrain(x, "act")

    def unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return self.constrain(layers.lm_head_logits(x, w), "logits")

    # -------------------------------------------------------------- qkv math
    def _qkv(self, p, x, positions):
        cfg = self.cfg
        b, t, d = x.shape
        hd = cfg.head_dim
        q = layers.dense(x, p["wq"].reshape(d, -1)).view(b, t, cfg.n_heads, hd)
        k = layers.dense(x, p["wk"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
        v = layers.dense(x, p["wv"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        if cfg.rope_theta:
            d_rot = int(hd * cfg.rope_fraction) // 2 * 2
            cos, sin = layers.rope_cos_sin(positions, d_rot, cfg.rope_theta)
            q = layers.apply_rope(q, cos, sin, d_rot)
            k = layers.apply_rope(k, cos, sin, d_rot)
        return (self.constrain(q, "q"), self.constrain(k, "kv"),
                self.constrain(v, "kv"))

    def _out_proj(self, p, out):
        b, t = out.shape[0], out.shape[1]
        out = self.constrain(out, "attn_out")
        return layers.dense(out.reshape(b, t, -1), p["wo"].reshape(-1, self.cfg.d_model))

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

    def _ffn_or_moe(self, p, x):
        """Returns (y, moe load-balance aux loss; 0 for a plain FFN)."""
        cfg = self.cfg
        if cfg.family != "moe":
            return layers.apply_ffn(p["ffn"], x, cfg.ffn_kind), 0.0
        b, s = x.shape[0], x.shape[1]
        # S-major flatten, as the reference: the order decides which tokens
        # capacity drops
        flat = moe.tokens_s_major(x)
        mo = moe.apply_moe(p["moe"], flat, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           ffn_kind=cfg.ffn_kind, constrain=self.constrain)
        y = mo.out.reshape(s, b, cfg.d_model).transpose(0, 1)
        if cfg.dense_ff:
            y = y + layers.apply_ffn(p["dense_ffn"], x, cfg.ffn_kind)
        return y, mo.aux_loss

    # ====================================================== dense stack
    def _dense_layer(self, lp, x, positions, kc=None, vc=None, cache_len=None,
                     decode=False):
        """One layer: returns (x, moe aux loss, (k, v))."""
        cfg = self.cfg
        h = layers.apply_norm(lp["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        if decode:
            y, kv = self._attn_block_decode(lp["attn"], h, kc, vc, cache_len)
        else:
            y, kv = self._attn_block_prefill(lp["attn"], h, positions)
        x = self.constrain(x + y, "act")
        h = layers.apply_norm(lp["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        y, aux_l = self._ffn_or_moe(lp, h)
        return self.constrain(x + y, "act"), aux_l, kv

    def _dense_stack(self, params, x, positions, *, k_caches=None,
                     v_caches=None, cache_len=None, decode=False,
                     return_kv=True):
        """Python loop over the stacked layers; returns (x, moe aux loss,
        (k, v)) with the per-layer KV stacked on a leading [L] axis (None
        with ``return_kv=False``, the training path's)."""
        ks, vs = [], []
        aux = 0.0
        for li in range(_n_layers(params)):
            lp = layer_params(params["layers"], li)
            if decode:
                kc = k_caches[li] if k_caches is not None else None
                vc = v_caches[li] if v_caches is not None else None
                x, aux_l, (k, v) = self._dense_layer(lp, x, None, kc, vc,
                                                     cache_len, decode=True)
            else:
                x, aux_l, (k, v) = maybe_remat(self.remat, self._dense_layer,
                                               lp, x, positions)
            aux = aux + aux_l
            if return_kv:
                ks.append(k)
                vs.append(v)
        if not return_kv:
            return x, aux, None
        return x, aux, (torch.stack(ks), torch.stack(vs))

    # ===================================================== hybrid stack
    def _hybrid_stack(self, params, x, positions, *, ssm_states=None,
                      k_caches=None, v_caches=None, cache_len=None,
                      decode=False):
        """zamba2: per superblock, its Mamba2 layers in order, then the
        shared attention + FFN block.  Returns (x, (k, v) stacked over the
        attention applications, SSMState with leaves [n_super, per, ...])."""
        ks, vs, hs, convs = [], [], [], []
        for si in range(_n_layers(params)):
            sp = layer_params(params["layers"]["mamba_layers"], si)
            if decode:
                x, (k, v), sh, sc = self._hybrid_super(
                    params, sp, x, None, si=si, ssm_states=ssm_states,
                    kc=k_caches[si], vc=v_caches[si], cache_len=cache_len,
                    decode=True)
            else:
                x, (k, v), sh, sc = maybe_remat(self.remat, self._hybrid_super,
                                                params, sp, x, positions)
            ks.append(k)
            vs.append(v)
            hs.append(sh)
            convs.append(sc)
        states = ssm.SSMState(h=torch.stack(hs), conv=torch.stack(convs))
        return x, (torch.stack(ks), torch.stack(vs)), states

    def _hybrid_super(self, params, sp, x, positions, *, si=None,
                      ssm_states=None, kc=None, vc=None, cache_len=None,
                      decode=False):
        """One superblock: its Mamba2 layers in order, then the shared
        attention + FFN block.  Returns (x, (k, v), h [per, ...], conv
        [per, ...])."""
        cfg = self.cfg
        sn = params["shared_norms"]
        sh, sc = [], []
        for j in range(_lead(sp)):
            mp = layer_params(sp, j)
            h = layers.apply_norm(mp["norm"], x, cfg.norm_kind, cfg.norm_eps)
            if decode:
                st = ssm.SSMState(ssm_states.h[si, j], ssm_states.conv[si, j])
                y, st = ssm.mamba2_decode_step(mp["mamba"], h, cfg, st)
            else:
                y, st = self.attn_impl.ssm_scan("mamba", mp["mamba"], h, cfg,
                                                None)
            x = x + y
            sh.append(st.h)
            sc.append(st.conv)
        h = layers.apply_norm(sn["n1"], x, cfg.norm_kind, cfg.norm_eps)
        if decode:
            y, kv = self._attn_block_decode(params["shared_attn"], h, kc, vc,
                                            cache_len)
        else:
            y, kv = self._attn_block_prefill(params["shared_attn"], h,
                                             positions)
        x = self.constrain(x + y, "act")
        h = layers.apply_norm(sn["n2"], x, cfg.norm_kind, cfg.norm_eps)
        x = self.constrain(
            x + layers.apply_ffn(params["shared_ffn"], h, cfg.ffn_kind), "act")
        return x, kv, torch.stack(sh), torch.stack(sc)

    # ======================================================= xlstm stack
    def _xlstm_stack(self, params, x, *, states=None, decode=False):
        """Per superblock: its mLSTM blocks in order, then its sLSTM block.
        Returns (x, (MLSTMState with leaves [n_super, m_per, B, ...],
        SLSTMState with leaves [n_super, B, ...]))."""
        mls, sls = [], []
        for si in range(_n_layers(params)):
            sp = layer_params(params["layers"], si)
            if decode:
                x, mst, sst = self._xlstm_super(sp, x, si=si, states=states,
                                                decode=True)
            else:  # the reference remats the superblock, never at decode
                x, mst, sst = maybe_remat(self.remat, self._xlstm_super, sp, x)
            mls.append(mst)
            sls.append(sst)
        return x, (xlstm.MLSTMState(*map(torch.stack, zip(*mls))),
                   xlstm.SLSTMState(*map(torch.stack, zip(*sls))))

    def _xlstm_super(self, sp, x, *, si=None, states=None, decode=False):
        """One superblock: its mLSTM blocks, then its sLSTM block.  Returns
        (x, MLSTMState with leaves [m_per, B, ...], SLSTMState)."""
        cfg = self.cfg
        ml = sp["mlstm_layers"]
        msts = []
        for j in range(_lead(ml)):
            mp = layer_params(ml, j)
            h = layers.apply_norm(mp["norm"], x, cfg.norm_kind, cfg.norm_eps)
            if decode:
                st = xlstm.MLSTMState(*(a[si, j] for a in states[0]))
                y, st = xlstm.mlstm_block_step(mp["cell"], h, cfg, st)
            else:
                y, st = self.attn_impl.ssm_scan("mlstm", mp["cell"], h, cfg,
                                                None)
            x = x + y
            msts.append(st)
        h = layers.apply_norm(sp["slstm"]["norm"], x, cfg.norm_kind,
                              cfg.norm_eps)
        if decode:
            sst = xlstm.SLSTMState(*(a[si] for a in states[1]))
            y, sst = xlstm.slstm_block_step(sp["slstm"]["cell"], h, cfg, sst)
        else:
            y, sst = self.attn_impl.ssm_scan("slstm", sp["slstm"]["cell"], h,
                                             cfg, None)
        x = self.constrain(x + y, "act")
        return x, xlstm.MLSTMState(*map(torch.stack, zip(*msts))), sst

    # ============================================================== public
    def hidden(self, params, batch, positions=None) -> Tuple[torch.Tensor, Any]:
        """Pre-unembed hidden states.  Returns (x [B,T,d], aux loss: the moe
        load-balance loss, 0 otherwise)."""
        x = self.embed_inputs(params, batch)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        family = self.cfg.family
        aux = 0.0
        if family == "hybrid":
            x, _, _ = self._hybrid_stack(params, x, positions)
        elif family == "ssm":
            x, _ = self._xlstm_stack(params, x)
        else:
            x, aux, _ = self._dense_stack(params, x, positions, return_kv=False)
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux.float()

    def forward(self, params, batch, positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward.  Returns (logits [B,T,V], aux loss)."""
        x, aux = self.hidden(params, batch, positions)
        return self.unembed(params, x), aux

    def prefill(self, params, batch, positions=None, *,
                last_logit_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Prefill: logits (+ populated cache).  With last_logit_only=True
        only the final *global* position (max of `positions`) is unembedded."""
        x = self.embed_inputs(params, batch)
        b, t = x.shape[0], x.shape[1]
        if positions is None:
            positions = torch.arange(t, device=x.device)
        length = torch.full((b,), t, dtype=torch.int32, device=x.device)
        if self.cfg.family == "hybrid":
            x, (k, v), states = self._hybrid_stack(params, x, positions)
            cache = Cache(k=k, v=v, length=length, ssm=states)
        elif self.cfg.family == "ssm":
            x, states = self._xlstm_stack(params, x)
            cache = Cache(length=length, ssm=states)
        else:
            x, _, (k, v) = self._dense_stack(params, x, positions)
            cache = Cache(k=k, v=v, length=length)
        if last_logit_only:
            x = _last_position(x, positions)
        return self.unembed(params, x), cache

    def prefill_packed_hidden(
        self, params, batch, positions
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The stack half of `prefill_packed`: embed + dense stack over the
        packed token axis — (x [1, T, d], (k, v) packed per-layer KV
        [L, T, KVH, D])."""
        x = self.embed_inputs(params, batch)  # [1, T, d]
        x, _, (k, v) = self._dense_stack(params, x, positions)  # [L, 1, T, ...]
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
        cache with length+1, per-layer new KV (k, v) each [L,B,1,KVH,D], or
        None for the ssm family); cache.k/v are NOT updated here — the
        engine / KV pool owns placement (LoongServe semantics)."""
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        x = layers.embed_lookup(params["embed"], tokens).to(self.dtype)
        x = self.constrain(x, "act")
        cl = cache.length
        if self.cfg.family == "hybrid":
            x, kvs, states = self._hybrid_stack(
                params, x, None, ssm_states=cache.ssm, k_caches=cache.k,
                v_caches=cache.v, cache_len=cl, decode=True,
            )
            new_cache = Cache(k=cache.k, v=cache.v, length=cl + 1, ssm=states)
        elif self.cfg.family == "ssm":
            x, states = self._xlstm_stack(params, x, states=cache.ssm,
                                          decode=True)
            kvs = None
            new_cache = Cache(length=cl + 1, ssm=states)
        else:
            x, _, kvs = self._dense_stack(
                params, x, None, k_caches=cache.k, v_caches=cache.v,
                cache_len=cl, decode=True,
            )
            new_cache = Cache(k=cache.k, v=cache.v, length=cl + 1)
        logits = self.unembed(params, x)[:, 0]
        return logits, new_cache, kvs

    def decode_sampled(self, params, tokens, cache: Cache):
        """One decode step + greedy sampling for whatever batch slice the
        caller holds: inside the batch-sharded SPMD iteration each rank runs
        it on its own B/n slice.  `torch.argmax` returns the first maximal
        index, as the local executor's `greedy_ids` and the reference's
        host `np.argmax` do, so ties break the same way.  Returns (sampled
        ids [b] int32, updated cache, per-layer new KV)."""
        logits, new_cache, kvs = self.decode(params, tokens, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache, kvs


def _last_position(x, positions):
    """x [B, T, d] at the final *global* position (the max of
    `positions`, correct under striped layouts) -> [B, 1, d].  A
    sequence-sharded DTensor takes the reference's masked reduction, which
    stays sharded (a slice at a computed index would gather x)."""
    from torch.distributed.tensor import DTensor

    t = x.shape[1]
    if isinstance(x, DTensor):
        pos = positions if isinstance(positions, DTensor) else \
            torch.as_tensor(positions, device=x.to_local().device).expand(t)
        sel = (pos == pos.max()).to(x.dtype)
        return torch.einsum("bsd,s->bd", x, sel)[:, None, :]
    pos = torch.as_tensor(positions, device=x.device).expand(t)
    # selected on the device: no host read (and none on meta tensors)
    return torch.index_select(x, 1, torch.argmax(pos).reshape(1))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Cache:
    """Preallocated (padded) cache for the dense-cache decode path: zero KV
    per attention application (None for the attention-free ssm family) and
    the zero recurrent state of a hybrid's Mamba2 layers (leaves [n_super,
    per, B, ...]) or of an xLSTM stack (`Model._xlstm_stack`'s layout)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    k = v = None
    if cfg.n_attention_applications:
        shape = (cfg.n_attention_applications, batch, max_len,
                 cfg.n_kv_heads, cfg.head_dim)
        k = torch.zeros(shape, dtype=torch_dtype(cfg.dtype), device=dev)
        v = torch.zeros_like(k)

    def stack(template, *lead):
        return type(template)(*(a.expand(lead + a.shape).clone()
                                for a in template))

    states = None
    if cfg.family == "hybrid":
        states = stack(ssm.init_ssm_state(cfg, batch, device=dev),
                       cfg.n_layers // cfg.hybrid_mamba_per_block,
                       cfg.hybrid_mamba_per_block)
    elif cfg.family == "ssm":
        n_super, m_per = xlstm_layout(cfg)
        states = (stack(xlstm.init_mlstm_state(cfg, batch, device=dev),
                        n_super, m_per),
                  stack(xlstm.init_slstm_state(cfg, batch, device=dev), n_super))
    return Cache(k=k, v=v,
                 length=torch.zeros((batch,), dtype=torch.int32, device=dev),
                 ssm=states)
