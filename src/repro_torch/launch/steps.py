"""Step builders: the PyTorch counterpart of `repro/launch/steps.py` at
``mesh=None``.

Three step kinds, as in the reference:
  * train_step  — loss (chunked cross-entropy over the vocabulary, ``-1``
                  labels masked, plus 0.01 x the moe load-balance loss),
                  gradients, optional int8 gradient compression, microbatch
                  accumulation in f32 and AdamW written over the parameter
                  dict; remat on the layer bodies;
  * prefill_step — last-position greedy token and the populated cache;
  * decode_step — one greedy token per request against a dense cache; the
                  new KV is returned for the caller to place.

Parameters are the port's nested dict of tensors (`repro_torch.convert`)
and stay in ``cfg.dtype``; the AdamW moments are f32.  A step is a function
of (params, opt_state, batch) that returns new trees, as the reference's
jitted step does.  On the card every attention layer of the train step's
forward and backward runs K4 (`kernels/striped_attention.py`): its
`StripedFlashAttentionFn` forward and hand-written backward.

On a `DeviceMesh` (every family) the steps run the reference's
global-view code over DTensors: parameters, inputs and optimizer state are
distributed by the spec rules (`launch.sharding`; `param_specs`,
`input_shardings`, `zero1_specs` / `opt_shardings` here), the model's
`constrain` hook redistributes activations, prefill and decode attention is
`core.esp.ESPAttnImpl` (the striped ring through K4, the multi-master
decode through K5, the recurrent layers' handoff) and the train step's is
`core.esp.ShardedAttnImpl` (K4 forward and backward per shard).  moe
routes globally and shards its grouped buffer by ``"moe_group"`` /
``"moe_hidden"`` (`models.moe.apply_moe`); vlm concatenates its
sequence-sharded image and text embeddings, image first; the audio
encoder-decoder runs its encoder batch-sharded and its cross-attention
against the replicated encoder output.  The train step is data-parallel
over the batch axes and tensor-parallel over "model", with ZeRO-1: the
AdamW moments are sharded over "data" (`zero1_specs`), the gradient is
reduce-scattered into that layout, the local shard updated and the
parameter all-gathered back.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import sharding as shlib
from repro_torch.launch.sharding import P
from repro_torch.models import build_model
from repro_torch.models.transformer import Cache, torch_dtype

B1, B2, EPS = 0.9, 0.95, 1e-8  # the reference's AdamW constants

def build_model_for(cfg: ModelConfig, mesh, kind: str, *, esp: bool = True,
                    remat: bool = False, dop: Optional[int] = None,
                    esp_opts: Optional[dict] = None, device="cuda"):
    """The model for a step of `kind` (``"train"``, ``"prefill"``,
    ``"decode"``).  At ``mesh=None`` the default attention (K4 / K5).  On
    a mesh: the sharding constraints of `kind` and, for prefill / decode
    with ``esp``, `ESPAttnImpl` over "data" (``dop`` sub-rings,
    ``esp_opts`` its other options; hybrid / ssm force batch mode), else
    `ShardedAttnImpl`."""
    if mesh is None:
        return build_model(cfg, remat=remat, device=device)
    from repro_torch.core.esp import ESPAttnImpl, ShardedAttnImpl

    names = tuple(mesh.mesh_dim_names)
    constrain = shlib.make_constrain(cfg, mesh, kind)
    if esp and kind in ("prefill", "decode") and "data" in names:
        attn_impl = ESPAttnImpl(
            mesh, cfg, sp_axis="data",
            tp_axis="model" if "model" in names else None,
            force_batch_mode=(cfg.family in ("hybrid", "ssm")),
            dop=dop, **(esp_opts or {}),
        )
    else:
        attn_impl = ShardedAttnImpl(mesh, cfg)
    return build_model(cfg, attn_impl=attn_impl, constrain=constrain,
                       remat=remat, device=device)


def mesh_context(mesh):
    """The context a mesh step runs in: plain tensors (constants the model
    makes, caller inputs) count as replicated DTensors."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _greedy(logits):
    """Greedy token ids: argmax over the vocabulary (first maximal index).
    A vocabulary-sharded DTensor first gathers its [B, V] rows over the
    axes that split V (small next to the model's activations); the batch
    keeps its split."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(logits, DTensor):
        vdim = logits.ndim - 1
        pl = [Replicate() if p.is_shard(vdim) else p for p in logits.placements]
        logits = logits.redistribute(logits.device_mesh, pl)
    return torch.argmax(logits, dim=-1)


def _local_device(x) -> torch.device:
    from torch.distributed.tensor import DTensor

    return x.to_local().device if isinstance(x, DTensor) else x.device


def full_value(x):
    """A DTensor's full value on every rank (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


# ================================================================ input specs


class TensorSpec(NamedTuple):
    """Shape and dtype of an input, without storage (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _sds(shape, dtype):
    return TensorSpec(tuple(shape), dtype)


def _pod_axis(mesh, b: int):
    sizes = shlib.axis_sizes(mesh)
    if "pod" in sizes and b % sizes["pod"] == 0:
        return ("pod",)
    return None


def decode_cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """KV tokens held at decode: SWA archs keep only the window."""
    s = shape.seq_len
    if cfg.sliding_window:
        s = min(s, cfg.sliding_window)
    # keep it shardable over data(16) x model(16), as the reference does
    return max(s, 256)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> Dict[str, Any]:
    """kwargs of `TensorSpec` stand-ins for the step of `shape.kind`."""
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        batch: Dict[str, Any] = {
            "tokens": _sds((b, s), i32),
            "labels": _sds((b, s), i32),
        }
        if cfg.frontend == "patch_stub":
            n_img = cfg.n_frontend_tokens
            batch["tokens"] = _sds((b, s - n_img), i32)
            # labels span the full (image+text) sequence; image positions
            # carry -1 (masked out of the CE loss)
            batch["labels"] = _sds((b, s), i32)
            batch["patch_embeds"] = _sds((b, n_img, cfg.d_model), dt)
        if cfg.frontend == "audio_stub":
            batch["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), dt)
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": _sds((b, s), i32)}
        if cfg.frontend == "patch_stub":
            n_img = cfg.n_frontend_tokens
            batch["tokens"] = _sds((b, s - n_img), i32)
            batch["patch_embeds"] = _sds((b, n_img, cfg.d_model), dt)
        if cfg.frontend == "audio_stub":
            batch["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), dt)
        return {"batch": batch, "positions": _sds((s,), i32)}
    # decode
    s_kv = decode_cache_len(cfg, shape)
    n_attn = cfg.n_attention_applications
    cache: Dict[str, Any] = {"length": _sds((b,), i32)}
    if n_attn:
        kv = _sds((n_attn, b, s_kv, cfg.n_kv_heads, cfg.head_dim), dt)
        cache["k"] = kv
        cache["v"] = kv
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.hybrid_mamba_per_block
        m_per = cfg.hybrid_mamba_per_block
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        cache["ssm_h"] = _sds(
            (n_super, m_per, b, nh, cfg.ssm_head_dim, cfg.ssm_state), f32)
        cache["ssm_conv"] = _sds(
            (n_super, m_per, b, cfg.ssm_conv_width - 1, d_in + 2 * cfg.ssm_state),
            f32)
    if cfg.family == "ssm":
        every = cfg.xlstm_slstm_every or (cfg.n_layers + 1)
        n_super = max(cfg.n_layers // every, 1)
        m_per = (cfg.n_layers // n_super) - 1
        d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
        dh = d_in // cfg.n_heads
        h = cfg.n_heads
        cache["xl_c"] = _sds((n_super, m_per, b, h, dh, dh), f32)
        cache["xl_n"] = _sds((n_super, m_per, b, h, dh), f32)
        cache["xl_m"] = _sds((n_super, m_per, b, h), f32)
        for key in ("sl_c", "sl_n", "sl_h", "sl_m"):
            cache[key] = _sds((n_super, b, d_in), f32)
    if cfg.is_encoder_decoder:
        cache["cross_k"] = _sds(
            (cfg.n_layers, b, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim), dt)
        cache["cross_v"] = cache["cross_k"]
    return {"tokens": _sds((b,), i32), "cache": cache}


def input_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """Spec tree (`sharding.P`) matching `input_specs`; `sharding.placements`
    / `sharding.distribute` place the tensors by it."""
    b = shape.global_batch
    ba = shlib.batch_axes(mesh, b)
    pod_b = _pod_axis(mesh, b)
    kd = shlib.kv_div(cfg, mesh)
    dhm = (cfg.family not in ("hybrid", "ssm")) and shlib.heads_mode(cfg, mesh) and kd

    if shape.kind == "train":
        out: Dict[str, Any] = {
            "batch": {"tokens": P(ba, None), "labels": P(ba, None)}
        }
        if cfg.frontend == "patch_stub":
            out["batch"]["patch_embeds"] = P(ba, None, None)
        if cfg.frontend == "audio_stub":
            out["batch"]["frames"] = P(ba, None, None)
        return out
    if shape.kind == "prefill":
        out = {"batch": {"tokens": P(pod_b, "data")}, "positions": P("data")}
        if cfg.frontend == "patch_stub":
            out["batch"]["patch_embeds"] = P(pod_b, "data", None)
        if cfg.frontend == "audio_stub":
            out["batch"]["frames"] = P(pod_b, None, None)
        return out
    # decode: multi-master masters over (pod, data); KV seq over data(+model)
    master_ax = ba
    cache: Dict[str, Any] = {"length": P(None)}
    if cfg.n_attention_applications:
        if dhm:  # heads mode: seq over data, kv heads over model
            kv_spec = P(None, pod_b, "data", "model", None)
        else:  # seq over (data, model)
            kv_spec = P(None, pod_b, ("data", "model"), None, None)
        cache["k"] = kv_spec
        cache["v"] = kv_spec
    if cfg.family == "hybrid":
        cache["ssm_h"] = P(None, None, master_ax)
        cache["ssm_conv"] = P(None, None, master_ax)
    if cfg.family == "ssm":
        for key in ("xl_c", "xl_n", "xl_m"):
            cache[key] = P(None, None, master_ax)
        for key in ("sl_c", "sl_n", "sl_h", "sl_m"):
            cache[key] = P(None, master_ax)
    if cfg.is_encoder_decoder:
        cache["cross_k"] = P(None, pod_b, None, None, None)
        cache["cross_v"] = cache["cross_k"]
    return {"tokens": P(master_ax), "cache": cache}


def cache_from_flat(cfg: ModelConfig, flat: Dict[str, Any]) -> Cache:
    """Rebuild the model Cache object from the flat spec dict."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xl_mod

    ssm_state = None
    if cfg.family == "hybrid":
        ssm_state = ssm_mod.SSMState(h=flat["ssm_h"], conv=flat["ssm_conv"])
    if cfg.family == "ssm":
        mst = xl_mod.MLSTMState(c=flat["xl_c"], n=flat["xl_n"], m=flat["xl_m"])
        sst = xl_mod.SLSTMState(
            c=flat["sl_c"], n=flat["sl_n"], h=flat["sl_h"], m=flat["sl_m"]
        )
        ssm_state = (mst, sst)
    return Cache(
        k=flat.get("k"),
        v=flat.get("v"),
        length=flat["length"],
        ssm=ssm_state,
        cross_k=flat.get("cross_k"),
        cross_v=flat.get("cross_v"),
    )


# ================================================================== steps


def make_prefill_step(cfg: ModelConfig, mesh=None, *, esp: bool = True,
                      dop: Optional[int] = None,
                      esp_opts: Optional[dict] = None, device="cuda"):
    """(model, prefill_step(batch, positions, params) -> (next token [B],
    Cache)).  On a mesh the inputs and parameters are DTensors (or plain
    tensors, taken as replicated) and so are the outputs."""
    model = build_model_for(cfg, mesh, "prefill", esp=esp, dop=dop,
                            esp_opts=esp_opts, device=device)

    @torch.no_grad()
    def prefill_step(batch, positions, params):
        with mesh_context(mesh):
            logits, cache = model.prefill(params, batch, positions,
                                          last_logit_only=True)
            next_token = _greedy(logits[:, -1])
        return next_token, cache

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, *, esp: bool = True,
                     dop: Optional[int] = None, device="cuda"):
    """(model, decode_step(tokens, cache, params) -> dict): one greedy
    token per request and the new KV / recurrent state."""
    model = build_model_for(cfg, mesh, "decode", esp=esp, dop=dop,
                            device=device)

    @torch.no_grad()
    def decode_step(tokens, cache, params):
        with mesh_context(mesh):
            return _decode(tokens, cache, params)

    def _decode(tokens, cache, params):
        cache_obj = cache_from_flat(cfg, cache)
        logits, new_cache, kvs = model.decode(params, tokens, cache_obj)
        next_token = _greedy(logits)
        out = {"next_token": next_token, "length": new_cache.length}
        if kvs is not None:
            out["new_k"], out["new_v"] = kvs
        if new_cache.ssm is not None and cfg.family == "hybrid":
            out["ssm_h"] = new_cache.ssm.h
            out["ssm_conv"] = new_cache.ssm.conv
        elif new_cache.ssm is not None and cfg.family == "ssm":
            mst, sst = new_cache.ssm
            out.update(xl_c=mst.c, xl_n=mst.n, xl_m=mst.m,
                       sl_c=sst.c, sl_n=sst.n, sl_h=sst.h, sl_m=sst.m)
        return out

    return model, decode_step


# ------------------------------------------------------------------ training


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def opt_state_shapes(params_shape):
    """`TensorSpec` tree of the AdamW state of a parameter tree (leaves
    with a shape: tensors, or `convert.param_shapes` entries)."""
    def zeros(path, leaf):
        return _sds(shlib._shape_of(leaf), torch.float32)

    m = shlib._map_with_path(zeros, params_shape)
    return {"m": m, "v": shlib._map_with_path(zeros, params_shape),
            "step": _sds((), torch.int32)}


def zero1_specs(param_spec_tree, params_shape, mesh):
    """ZeRO-1: shard optimizer moments over `data` on the first dim that is
    unsharded and divisible (falls back to the param's own sharding). Each
    data-rank then owns 1/|data| of the moments; the post-update all-gather
    of params is the classic ZeRO-1 collective."""
    sizes = shlib.axis_sizes(mesh)
    dsz = sizes.get("data", 1)

    def one(path, leaf):
        spec = shlib._get(param_spec_tree, path)
        shp = shlib._shape_of(leaf)
        dims = list(spec) + [None] * (len(shp) - len(spec))

        def used(ax):
            for d in dims:
                if d == ax or (isinstance(d, tuple) and ax in d):
                    return True
            return False

        if "data" in sizes and not used("data"):
            for i, (d, cur) in enumerate(zip(shp, dims)):
                if cur is None and d % dsz == 0 and d >= dsz:
                    dims[i] = "data"
                    break
        return P(*dims)

    return shlib._map_with_path(one, params_shape)


def opt_shardings(cfg, mesh, params_shape):
    """Full opt-state spec tree {m, v, step}."""
    z = zero1_specs(shlib.param_specs(cfg, mesh, params_shape, train=True),
                    params_shape, mesh)
    return {"m": z, "v": shlib._map_with_path(lambda _p, s: s, z),
            "step": P()}


def place_params(cfg, mesh, params, *, train: bool = False):
    """The parameter tree as DTensors by ``param_specs(..., train)`` (every
    rank holds the same full tree; each keeps its blocks)."""
    return shlib.distribute(params, mesh,
                            shlib.param_specs(cfg, mesh, params, train=train))


def place_opt_state(cfg, mesh, opt_state):
    """The AdamW state as DTensors by `opt_shardings` (ZeRO-1 moments)."""
    specs = opt_shardings(cfg, mesh, opt_state["m"])
    return {"m": shlib.distribute(opt_state["m"], mesh, specs["m"]),
            "v": shlib.distribute(opt_state["v"], mesh, specs["v"]),
            "step": opt_state["step"]}


def init_opt_state(params):
    """AdamW state: f32 zero moments shaped like the parameters, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def compress_int8(x: torch.Tensor) -> torch.Tensor:
    """The reference's int8 gradient compression of one leaf: per-tensor
    scale ``max(max|x|, 1e-8) / 127`` in x's dtype, round half to even (as
    ``jnp.round``), clip to [-127, 127], back to x's dtype.  Leaves of
    other dtypes pass through."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return x
    scale = torch.clamp(x.abs().max(), min=1e-8) / 127.0
    xi = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return (xi.to(x.dtype) * scale).to(x.dtype)


def _mark(dev: torch.device):
    """A point in time for a span: a recorded CUDA event on the card, the
    host clock elsewhere."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _add_span(spans: Optional[dict], name: str, start, end) -> None:
    """Add the milliseconds between two marks to ``spans[name]`` (waits for
    the end event on the card)."""
    if spans is None:
        return
    if isinstance(start, float):
        ms = (end - start) * 1e3
    else:
        end.synchronize()
        ms = start.elapsed_time(end)
    spans[name] = spans.get(name, 0.0) + ms


def _logsumexp(x):
    """logsumexp over the last dim as max + log(sum(exp(x - max))) with the
    max held constant (as ``jax.scipy.special.logsumexp`` does): over a
    vocabulary-sharded DTensor the max and the sum reduce across shards
    (small [B, c] all-reduces) and the logits are never gathered."""
    m = x.amax(dim=-1).detach()
    return m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))


def _label_logit(logits, labels):
    """logits[..., label] ([B, c]; a -1 label reads index 0).  Over a
    vocabulary-sharded DTensor the gather is vocabulary-parallel (each
    shard reads the labels it holds, a partial sum the rest); that partial
    is reduced on the gathered [B, c, 1] before the last dim goes."""
    from torch.distributed.tensor import DTensor, Partial as PartialPl

    tok = torch.gather(logits, -1, labels.clamp_min(0)[..., None].long())
    if isinstance(tok, DTensor) and any(isinstance(p, PartialPl)
                                        for p in tok.placements):
        from torch.distributed.tensor import Replicate

        tok = tok.redistribute(tok.device_mesh, [
            Replicate() if isinstance(p, PartialPl) else p
            for p in tok.placements])
    return tok[..., 0]


def make_train_step(cfg: ModelConfig, mesh=None, *, lr: float = 3e-4,
                    wd: float = 0.01, loss_chunk: int = 1024,
                    grad_compression: Optional[str] = None,
                    remat: bool = True, microbatches: int = 1,
                    device="cuda"):
    """Returns (model, train_step); ``train_step(params, opt_state, batch)
    -> (new_params, new_opt_state, {"loss", "aux", "grad_norm"})``.  batch:
    ``tokens`` [B, S] and ``labels`` [B, S'] (``-1`` = no loss), plus
    ``patch_embeds`` (vlm) or ``frames`` (audio).  Passing a dict as
    ``spans=`` adds the milliseconds of the step's forward (loss), backward
    (gradients) and optimizer (compression, AdamW, grad norm) to it: CUDA
    events on the card, which then wait for each phase to finish; without
    it nothing is recorded.

    On a mesh the parameters are DTensors placed by ``param_specs(...,
    train=True)`` and the moments by `opt_shardings` (ZeRO-1); the batch is
    placed by `input_shardings` (or plain, taken as replicated).  Each
    gradient is redistributed into its moments' layout (a reduce-scatter
    over "data" of the partial gradient), the AdamW update runs on the
    local shard and the parameter is redistributed back to its own layout
    (the ZeRO-1 all-gather).  The metrics come back as plain tensors."""
    model = build_model_for(cfg, mesh, "train", esp=False, remat=remat,
                            device=device)

    def loss_fn(params, batch):
        """(loss + 0.01 aux, loss, aux): the cross-entropy over chunks of
        `loss_chunk` positions, so [B, S, V] logits never exist at once."""
        x, aux = model.hidden(params, batch)
        labels = batch["labels"]
        s = x.shape[1]
        chunk = min(loss_chunk, s)
        nll = x.new_zeros((), dtype=torch.float32)
        cnt = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, s, chunk):  # the reference pads the last chunk
            ll = labels[:, c0:c0 + chunk]
            logits = model.unembed(params, x[:, c0:c0 + chunk])  # [B, c, V] f32
            logz = (_logsumexp(logits) if mesh is not None
                    else torch.logsumexp(logits, dim=-1))
            tok = _label_logit(logits, ll)
            valid = ll >= 0
            nll = nll + torch.where(valid, logz - tok, torch.zeros_like(logz)).sum()
            cnt = cnt + valid.sum()
        loss = nll / torch.clamp(cnt, min=1).float()
        total = loss + 0.01 * aux
        if mesh is not None:
            total, loss, aux = full_value(total), full_value(loss), full_value(aux)
        return total, loss, aux

    def microbatch(a, i):
        """Rows [i n, (i + 1) n) of the batch (batch-major, as the
        reference splits), on a mesh placed over the batch axes again."""
        n = a.shape[0] // microbatches
        if mesh is None:
            return a[i * n:(i + 1) * n]
        # the batch's token ids are small next to its activations: gather
        # them, slice, and place the slice (no data moves for that)
        part = full_value(a)[i * n:(i + 1) * n]
        spec = P(shlib.batch_axes(mesh, n), *([None] * (part.ndim - 1)))
        return shlib.distribute(part, mesh, spec)

    def grads_of(params, batch, spans):
        """(grads in the parameters' dtypes, loss, aux) of one batch."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        dev = _local_device(leaves[0])
        with torch.enable_grad():
            t0 = _mark(dev) if spans is not None else None
            total, loss, aux = loss_fn(_unflatten(params, leaves), batch)
            t1 = _mark(dev) if spans is not None else None
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
            t2 = _mark(dev) if spans is not None else None
        _add_span(spans, "forward", t0, t1)
        _add_span(spans, "backward", t1, t2)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
        return gs, loss.detach(), aux.detach()

    def train_step(params, opt_state, batch, spans: Optional[dict] = None):
        with mesh_context(mesh):
            return _train_step(params, opt_state, batch, spans)

    def _train_step(params, opt_state, batch, spans):
        if microbatches > 1:
            # gradient accumulation in f32 over batch-major contiguous slices
            grads, loss, aux = None, 0.0, 0.0
            for i in range(microbatches):
                mb = {k: microbatch(v, i) for k, v in batch.items()}
                g, l_, a_ = grads_of(params, mb, spans)
                g = [x.float() for x in g]
                grads = g if grads is None else [x + y for x, y in zip(grads, g)]
                loss, aux = loss + l_, aux + a_
            grads = [g / microbatches for g in grads]
            loss, aux = loss / microbatches, aux / microbatches
        else:
            grads, loss, aux = grads_of(params, batch, spans)
        t3 = _mark(_local_device(grads[0])) if spans is not None else None
        p_leaves = tree_leaves(params)
        m_leaves = tree_leaves(opt_state["m"])
        if mesh is not None:
            # ZeRO-1: the (partial) gradient reduce-scattered into its
            # moments' layout, the parameter sliced to it (no data moves)
            grads = [g.redistribute(m.device_mesh, m.placements)
                     for g, m in zip(grads, m_leaves)]
            p_work = [p.redistribute(m.device_mesh, m.placements)
                      for p, m in zip(p_leaves, m_leaves)]
        else:
            p_work = p_leaves
        if grad_compression == "int8":
            grads = [compress_int8(g) for g in grads]
        step = opt_state["step"] + 1
        sf = step.float()
        bc1 = 1.0 - torch.pow(B1, sf)
        bc2 = 1.0 - torch.pow(B2, sf)
        new_p, new_m, new_v = [], [], []
        for p, pw, g, m, v in zip(p_leaves, p_work, grads, m_leaves,
                                  tree_leaves(opt_state["v"])):
            gf = g.float()
            m_new = B1 * m + (1 - B1) * gf
            v_new = B2 * v + (1 - B2) * gf * gf
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
            pf = pw.float()
            p_new = (pf - lr * (u + wd * pf)).to(p.dtype)
            if mesh is not None:  # the ZeRO-1 all-gather
                p_new = p_new.redistribute(p.device_mesh, p.placements)
            new_p.append(p_new)
            new_m.append(m_new)
            new_v.append(v_new)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        if spans is not None:
            _add_span(spans, "optimizer", t3, _mark(_local_device(grads[0])))
        return (_unflatten(params, new_p),
                {"m": _unflatten(params, new_m), "v": _unflatten(params, new_v),
                 "step": step},
                {"loss": full_value(loss), "aux": full_value(aux),
                 "grad_norm": full_value(gnorm)})

    return model, train_step
