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

The mesh-aware half of the reference (`ESPAttnImpl`, sharding constraints,
`input_specs` / `input_shardings`, ZeRO-1 `zero1_specs` / `opt_shardings`)
belongs to the dry-run slice (ROADMAP queue 1, item 14): a mesh raises.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import build_model
from repro_torch.models.transformer import Cache

B1, B2, EPS = 0.9, 0.95, 1e-8  # the reference's AdamW constants


def build_model_for(cfg: ModelConfig, mesh, kind: str, *, remat: bool = False,
                    device="cuda"):
    """The model for a step of `kind` (``"train"``, ``"prefill"``,
    ``"decode"``) at ``mesh=None``: the default attention (K4 / K5).  The
    reference's ESP options (``esp``, ``dop``, ``esp_opts``) select
    `ESPAttnImpl` on a mesh and come with the mesh-aware slice."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-aware steps (ESPAttnImpl, sharding constraints, ZeRO-1) "
            "are the next slice of ROADMAP queue 1 item 14; pass mesh=None")
    return build_model(cfg, remat=remat, device=device)


def decode_cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """KV tokens held at decode: SWA archs keep only the window."""
    s = shape.seq_len
    if cfg.sliding_window:
        s = min(s, cfg.sliding_window)
    # keep it shardable over data(16) x model(16), as the reference does
    return max(s, 256)


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


def make_prefill_step(cfg: ModelConfig, mesh=None, *, device="cuda"):
    model = build_model_for(cfg, mesh, "prefill", device=device)

    @torch.no_grad()
    def prefill_step(batch, positions, params):
        logits, cache = model.prefill(params, batch, positions,
                                      last_logit_only=True)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token, cache

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, *, device="cuda"):
    model = build_model_for(cfg, mesh, "decode", device=device)

    @torch.no_grad()
    def decode_step(tokens, cache, params):
        cache_obj = cache_from_flat(cfg, cache)
        logits, new_cache, kvs = model.decode(params, tokens, cache_obj)
        next_token = torch.argmax(logits, dim=-1)
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
    it nothing is recorded."""
    model = build_model_for(cfg, mesh, "train", remat=remat, device=device)

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
            logz = torch.logsumexp(logits, dim=-1)
            tok = torch.gather(logits, -1, ll.clamp_min(0)[..., None].long())[..., 0]
            valid = ll >= 0
            nll = nll + torch.where(valid, logz - tok, torch.zeros_like(logz)).sum()
            cnt = cnt + valid.sum()
        loss = nll / torch.clamp(cnt, min=1).float()
        return loss + 0.01 * aux, loss, aux

    def grads_of(params, batch, spans):
        """(grads in the parameters' dtypes, loss, aux) of one batch."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        dev = leaves[0].device
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
        if microbatches > 1:
            # gradient accumulation in f32 over batch-major contiguous slices
            def split(a, i):
                n = a.shape[0] // microbatches
                return a[i * n:(i + 1) * n]

            grads, loss, aux = None, 0.0, 0.0
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                g, l_, a_ = grads_of(params, mb, spans)
                g = [x.float() for x in g]
                grads = g if grads is None else [x + y for x, y in zip(grads, g)]
                loss, aux = loss + l_, aux + a_
            grads = [g / microbatches for g in grads]
            loss, aux = loss / microbatches, aux / microbatches
        else:
            grads, loss, aux = grads_of(params, batch, spans)
        t3 = _mark(grads[0].device) if spans is not None else None
        if grad_compression == "int8":
            grads = [compress_int8(g) for g in grads]
        step = opt_state["step"] + 1
        sf = step.float()
        bc1 = 1.0 - torch.pow(B1, sf)
        bc2 = 1.0 - torch.pow(B2, sf)
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(tree_leaves(params), grads,
                              tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"])):
            gf = g.float()
            m_new = B1 * m + (1 - B1) * gf
            v_new = B2 * v + (1 - B2) * gf * gf
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
            pf = p.float()
            new_p.append((pf - lr * (u + wd * pf)).to(p.dtype))
            new_m.append(m_new)
            new_v.append(v_new)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        if spans is not None:
            _add_span(spans, "optimizer", t3, _mark(grads[0].device))
        return (_unflatten(params, new_p),
                {"m": _unflatten(params, new_m), "v": _unflatten(params, new_v),
                 "step": step},
                {"loss": loss, "aux": aux, "grad_norm": gnorm})

    return model, train_step
