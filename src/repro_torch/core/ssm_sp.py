"""Sequence parallelism for recurrent layers (hybrid zamba2 / xlstm archs):
the port of `repro/core/ssm_sp.py`.

ESP's striped KV ring is inapplicable to recurrent state (DESIGN.md §4); the
analogue implemented here is a 3-phase chunk-state handoff on the *contiguous*
layout:

  1. local state-only fold: each rank folds its sequence segment into a
     single (state, decay) summary from zero init — cheap (skips output math);
  2. log-step exclusive device scan over the `sp` axis (Hillis-Steele with
     pairwise sends, `ops.ppermute` by `_shift_pairs`) under the layer's
     state monoid (SSD: linear decay; mLSTM: max-stabilized log-space);
  3. local full pass seeded with the true incoming state.

sLSTM is inherently sequential (xLSTM §2.3): its input is all-gathered and the
scalar recurrence runs redundantly per rank (cheap — no matmuls in the scan),
each rank keeping its local slice.

Batch shards over `tp` when divisible (recurrent layers are batch-parallel);
weights stay replicated — recurrent-layer TP alternatives are a §Perf lever.

Each function is one `launch.mesh.shmap` (`local_map`) body over DTensors.
Inside it the rank is a Python int, so the reference's ``where(has, ...)``
after a shift is a branch: a rank that received nothing keeps its value,
which is the combine with the identity the reference substitutes (decay 1,
``m = -inf``, ``b = 0``) without computing with it — no ``-inf - -inf``
reaches `torch.maximum`.  Rank 0's incoming state is zeros (``m = -inf``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch.mesh import axis_info, axis_size
from repro_torch.models import ssm, xlstm


def _shift_pairs(n: int, shift: int = 1):
    return [(i, i + shift) for i in range(n - shift)]


def _select_last(x, group, n: int, rank: int, reduce: str = "sum"):
    """Replicate the last rank's value to every rank."""
    if reduce == "max":
        return ops.pmax(x if rank == n - 1 else torch.full_like(x, -torch.inf),
                        group)
    return ops.psum(x if rank == n - 1 else torch.zeros_like(x), group)


def _ssd_device_exclusive_scan(h_seg, d_seg, group, n: int, rank: int):
    """Exclusive scan of (decay, state) pairs over the sp axis. Returns the
    state entering each rank (zeros at rank 0). Hillis-Steele: log2(n) steps."""
    h, d = h_seg, d_seg
    shift = 1
    while shift < n:
        hr, dr = ops.ppermute((h, d), group, _shift_pairs(n, shift))
        if rank >= shift:  # else: decay identity 1, h unchanged
            h = hr * d[:, :, None, None] + h
            d = dr * d
        shift *= 2
    # exclusive = inclusive shifted right by one rank
    h_excl = ops.ppermute(h, group, _shift_pairs(n, 1))
    return h_excl if rank >= 1 else torch.zeros_like(h_excl)


def _mlstm_device_exclusive_scan(st: xlstm.MLSTMState, btot, group, n: int,
                                 rank: int):
    """Same, under the mLSTM max-stabilized monoid."""
    c, nn, m, b = st.c, st.n, st.m, btot
    shift = 1
    while shift < n:
        cr, nr, mr, br = ops.ppermute((c, nn, m, b), group,
                                      _shift_pairs(n, shift))
        if rank >= shift:  # else: identity m = -inf, b = 0
            comb = xlstm.mlstm_combine_states(
                xlstm.MLSTMState(cr, nr, mr), xlstm.MLSTMState(c, nn, m), b
            )
            c, nn, m, b = comb.c, comb.n, comb.m, br + b
        shift *= 2
    cr, nr, mr = ops.ppermute((c, nn, m), group, _shift_pairs(n, 1))
    if rank < 1:
        return xlstm.MLSTMState(torch.zeros_like(cr), torch.zeros_like(nr),
                                torch.full_like(mr, -torch.inf))
    return xlstm.MLSTMState(cr, nr, mr)


def _batch_axis(mesh, tp, batch):
    if tp and tp in mesh.mesh_dim_names and batch % axis_size(mesh, tp) == 0:
        return tp
    return None


def _spec(lead, ndim: int, seq=None):
    from repro_torch.launch.sharding import P

    return P(lead, *([seq] if ndim > 1 else []), *([None] * (ndim - 2)))


def _state_specs(kind: str, lead, cfg):
    """Specs of a layer's final state: the batch dim over ``lead``."""
    if kind == "mamba":
        return ssm.SSMState(_spec(lead, 4), _spec(lead, 3))
    if kind == "mlstm":
        return xlstm.MLSTMState(_spec(lead, 4), _spec(lead, 3), _spec(lead, 2))
    return xlstm.SLSTMState(*(_spec(lead, 2),) * 4)


def _sp_run(mesh, sp, body, p, x, out_lead, kind, cfg):
    from repro_torch.launch.mesh import shmap
    from repro_torch.launch.sharding import P

    return shmap(body, mesh, (P(out_lead, sp, None), P()),
                 (P(out_lead, sp, None), _state_specs(kind, out_lead, cfg)))(x, p)


# ===================================================================== mamba


def mamba2_forward_sp(mesh, sp, p, x, cfg, state, *, tp=None):
    """x [B, S(global), d] contiguous layout, sharded S over sp. Returns
    (y, SSMState) with the state replicated over sp (the true global final
    state)."""
    assert state is None, "SP prefill starts from a fresh state"
    n, rank, group = axis_info(mesh, sp)
    btp = _batch_axis(mesh, tp, x.shape[0])
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim

    def body(xb, pp):
        zxbcdt = xb @ pp["w_in"]
        z, xs_, b_, c_, dt = ssm._split_proj(zxbcdt, d_in, cfg.ssm_state,
                                             n_heads)
        xbc = torch.cat([xs_, b_, c_], dim=-1)
        # conv handoff: receive the left neighbour's tail (zeros at rank 0)
        w = pp["conv_w"].shape[0]
        tail = xbc[:, xbc.shape[1] - (w - 1):, :]
        recv = ops.ppermute(tail, group, _shift_pairs(n, 1))
        xbc, my_tail = ssm._causal_conv(xbc, pp["conv_w"], pp["conv_b"], recv)
        xs_ = xbc[..., :d_in]
        b_ = xbc[..., d_in:d_in + cfg.ssm_state]
        c_ = xbc[..., d_in + cfg.ssm_state:]
        dt = ssm._softplus(dt.float() + pp["dt_bias"][None, None, :])
        a = -torch.exp(pp["A_log"])
        xh = xs_.reshape(*xs_.shape[:2], n_heads, cfg.ssm_head_dim)
        # 3-phase handoff
        h_seg, d_seg = ssm.ssd_state_only(xh, dt, a, b_, cfg.ssm_chunk)
        h_in = _ssd_device_exclusive_scan(h_seg, d_seg, group, n, rank)
        y, h_fin = ssm.ssd_chunk_scan(xh, dt, a, b_, c_, cfg.ssm_chunk, h_in)
        y = y + xh.float() * pp["D"][None, None, :, None]
        y = y.reshape(*xs_.shape[:2], d_in).to(xb.dtype)
        y = ssm._gated_norm(y, z, pp["norm_scale"])
        out = y @ pp["w_out"]
        h_last = _select_last(h_fin, group, n, rank)
        conv_last = _select_last(my_tail.float(), group, n, rank)
        return out, ssm.SSMState(h_last, conv_last)

    return _sp_run(mesh, sp, body, p, x, btp, "mamba", cfg)


# ===================================================================== mlstm


def mlstm_forward_sp(mesh, sp, p, x, cfg, state, *, tp=None):
    assert state is None, "SP prefill starts from a fresh state"
    n, rank, group = axis_info(mesh, sp)
    btp = _batch_axis(mesh, tp, x.shape[0])
    chunk = min(cfg.ssm_chunk or 64, max(x.shape[1] // n, 1))

    def body(xb, pp):
        q, k, v, o, ig, fg, z, dh = xlstm._mlstm_qkvif(pp, xb, cfg)
        seg, btot = xlstm.mlstm_state_only(k, v, ig, fg, chunk)
        st_in = _mlstm_device_exclusive_scan(seg, btot, group, n, rank)
        htilde, st_fin = xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk, st_in)
        h = htilde.reshape(*xb.shape[:2], -1) * o
        h = h * F.silu(z)
        out = h @ pp["w_down"]
        st_last = xlstm.MLSTMState(
            c=_select_last(st_fin.c, group, n, rank),
            n=_select_last(st_fin.n, group, n, rank),
            m=_select_last(st_fin.m, group, n, rank, reduce="max"),
        )
        return out, st_last

    return _sp_run(mesh, sp, body, p, x, btp, "mlstm", cfg)


# ===================================================================== slstm


def slstm_forward_sp(mesh, sp, p, x, cfg, state, *, tp=None):
    assert state is None, "SP prefill starts from a fresh state"
    n, rank, group = axis_info(mesh, sp)
    btp = _batch_axis(mesh, tp, x.shape[0])
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)

    def body(xb, pp):
        up = xb @ pp["w_up"]
        xm, z = up[..., :d_in], up[..., d_in:]
        xm_full = ops.all_gather(xm, group, axis=1)  # [B, S, d_in]
        st0 = xlstm.init_slstm_state(cfg, xb.shape[0], device=xb.device)
        h_full, st = xlstm.slstm_scan(pp, xm_full, cfg, st0)
        s_l = xm.shape[1]
        h_loc = h_full[:, rank * s_l:(rank + 1) * s_l]
        h = h_loc * F.silu(z)
        out = h @ pp["w_down"]
        return out, st

    return _sp_run(mesh, sp, body, p, x, btp, "slstm", cfg)


# ============================================================ whole per rank


def recurrent_local(mesh, kind, p, x, cfg, state, *, tp: Optional[str] = None,
                    batch_only: bool = False):
    """A recurrent layer whole on each rank's batch shard (``n_sp == 1``
    prefill, and the mesh train step): the batch over ``tp`` when it
    divides (prefill), or over the batch axes (pod, data) of the train
    constraint (``batch_only``); weights replicated, their gradients
    partial over the axes the batch shards."""
    from torch.distributed.tensor import Partial as PartialPl
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import shmap
    from repro_torch.launch.sharding import P
    from repro_torch.models.transformer import DefaultAttnImpl

    if batch_only:
        lead = shlib.batch_axes(mesh, x.shape[0])
    else:
        lead = _batch_axis(mesh, tp, x.shape[0])
    over = (lead if isinstance(lead, tuple) else (lead,)) if lead else ()
    names = tuple(mesh.mesh_dim_names)
    rep = shlib.placements(mesh, P(), 0)
    grad_p = tuple(PartialPl() if names[i] in over else pl
                   for i, pl in enumerate(rep))

    assert state is None, "a prefill / train layer starts from a fresh state"

    def body(xb, pp):
        return DefaultAttnImpl().ssm_scan(kind, pp, xb, cfg, None)

    return shmap(body, mesh, (P(lead, None, None), P()),
                 (P(lead, None, None), _state_specs(kind, lead, cfg)),
                 in_grad_specs=(None, grad_p))(x, p)
