"""Mamba2 (SSD) layer: chunked-parallel prefill scan + O(1) recurrent decode.

PyTorch counterpart of `repro/models/ssm.py`, same layouts and parameter
names (``w_in [d, 2*d_in + 2*N + H]``, ``conv_w [W, conv_dim]``, ...).  The
chunked form computes all intra-chunk work in parallel over
``[n_chunks, L, ...]`` and runs a Python loop (the reference's ``lax.scan``)
only for the inter-chunk state recurrence.  No Pallas kernel is involved.

State per layer: ``SSMState(h [B, H, P, N] f32, conv [B, W-1, conv_dim])``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class SSMState(NamedTuple):
    h: torch.Tensor  # [..., B, H, P, N] f32
    conv: torch.Tensor  # [..., B, W-1, conv_dim] last inputs for causal conv


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0).  torch's `F.softplus` turns
    into the identity above its threshold (20), which is not the same
    function."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(zxbcdt, d_in, state, n_heads):
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    b = zxbcdt[..., 2 * d_in:2 * d_in + state]
    c = zxbcdt[..., 2 * d_in + state:2 * d_in + 2 * state]
    dt = zxbcdt[..., 2 * d_in + 2 * state:]
    return z, x, b, c, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 init: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. xbc [B,T,C], w [W,C]. Returns
    (silu(out) [B,T,C], new_tail [B,W-1,C])."""
    width, t = w.shape[0], xbc.shape[1]
    if init is None:
        init = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([init.to(xbc.dtype), xbc], dim=1)
    out = sum(padded[:, i:i + t, :] * w[i][None, None, :] for i in range(width))
    out = out + bias[None, None, :]
    tail = padded[:, padded.shape[1] - (width - 1):, :]
    return F.silu(out), tail


def _gated_norm(y, z, scale, eps=1e-5):
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(var + eps) * scale.float()
    return (yn * F.silu(z.float())).to(y.dtype)


def _pad_time(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (time) at the end by `pad` steps."""
    shape = (a.shape[0], pad) + tuple(a.shape[2:])
    return torch.cat([a, a.new_zeros(shape)], dim=1)


def _chunk_terms(x, dt, a, b, chunk):
    """Shared prologue of the chunked scans: pad to a chunk multiple (dt = 0
    at padded steps: the state passes through and they contribute nothing)
    and reshape to chunks."""
    bsz, t_orig, h, pdim = x.shape
    n = b.shape[-1]
    pad = (-t_orig) % chunk
    if pad:
        x, dt, b = _pad_time(x, pad), _pad_time(dt, pad), _pad_time(b, pad)
    nc = (t_orig + pad) // chunk
    xc = x.float().reshape(bsz, nc, chunk, h, pdim)
    bc = b.float().reshape(bsz, nc, chunk, n)
    da = dt * a[None, None, :]  # [B,T,H] negative
    dtc = dt.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(da.reshape(bsz, nc, chunk, h), dim=2)
    # chunk-local final state + total decay
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # [B,nc,L,H]
    h_loc = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, bc, xc)  # [B,nc,H,P,N]
    decay_tot = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    return pad, xc, bc, dtc, cum, h_loc, decay_tot, da


def ssd_chunk_scan(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] f32 (post softplus)
    a: torch.Tensor,  # [H] f32 negative
    b: torch.Tensor,  # [B, T, N]
    c: torch.Tensor,  # [B, T, N]
    chunk: int,
    h_init: Optional[torch.Tensor] = None,  # [B, H, P, N] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y [B,T,H,P] in x.dtype, h_final [B,H,P,N])."""
    bsz, t_orig, h, pdim = x.shape
    n = b.shape[-1]
    pad, xc, bc, dtc, cum, h_loc, decay_tot, _ = _chunk_terms(x, dt, a, b, chunk)
    if pad:
        c = _pad_time(c, pad)
    nc = xc.shape[1]
    cc = c.float().reshape(bsz, nc, chunk, n)

    # ---- intra-chunk (parallel over all chunks) ----
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)  # [B,nc,L,L]
    dd = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,L,L,H]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    m = torch.where(causal, torch.exp(dd), torch.zeros((), device=x.device))
    m = m * g[..., None] * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # ---- inter-chunk recurrence ----
    hprev = (h_init.float() if h_init is not None
             else torch.zeros((bsz, h, pdim, n), dtype=torch.float32,
                              device=x.device))
    y_inter = []
    for ci in range(nc):
        y_inter.append(torch.einsum("bln,bhpn->blhp", cc[:, ci], hprev)
                       * torch.exp(cum[:, ci])[..., None])
        hprev = hprev * decay_tot[:, ci, :, None, None] + h_loc[:, ci]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(bsz, nc * chunk, h, pdim)
    return y[:, :t_orig].to(x.dtype), hprev


def ssd_state_only(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] f32
    a: torch.Tensor,  # [H] f32 negative
    b: torch.Tensor,  # [B, T, N]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-state fold: (h_seg [B,H,P,N] = final state from zero init,
    decay_seg [B,H] = total decay across the segment).  Skips all output
    math."""
    bsz, _, h, pdim = x.shape
    n = b.shape[-1]
    _, xc, _, _, _, h_loc, decay_tot, da = _chunk_terms(x, dt, a, b, chunk)
    h_seg = torch.zeros((bsz, h, pdim, n), dtype=torch.float32, device=x.device)
    for ci in range(xc.shape[1]):
        h_seg = h_seg * decay_tot[:, ci, :, None, None] + h_loc[:, ci]
    return h_seg, torch.exp(da.sum(dim=1))


def _project(p, xin, cfg, conv_init):
    """in_proj -> split -> causal conv -> (z, x, b, c, dt post-softplus, a,
    conv tail)."""
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    zxbcdt = xin @ p["w_in"]
    z, x, b, c, dt = _split_proj(zxbcdt, d_in, cfg.ssm_state, n_heads)
    xbc, tail = _causal_conv(torch.cat([x, b, c], dim=-1), p["conv_w"],
                             p["conv_b"], conv_init)
    x = xbc[..., :d_in]
    b = xbc[..., d_in:d_in + cfg.ssm_state]
    c = xbc[..., d_in + cfg.ssm_state:]
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["A_log"])
    return z, x, b, c, dt, a, tail, n_heads, d_in


def mamba2_forward(p: dict, xin: torch.Tensor, cfg,
                   state: Optional[SSMState] = None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence (prefill) mamba2 layer. xin [B, T, d]."""
    z, x, b, c, dt, a, tail, n_heads, d_in = _project(
        p, xin, cfg, state.conv if state is not None else None)
    bsz, t = x.shape[0], x.shape[1]
    xh = x.reshape(bsz, t, n_heads, cfg.ssm_head_dim)
    y, h_final = ssd_chunk_scan(xh, dt, a, b, c, cfg.ssm_chunk,
                                state.h if state is not None else None)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(bsz, t, d_in).to(xin.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    return y @ p["w_out"], SSMState(h=h_final, conv=tail)


def mamba2_decode_step(p: dict, xin: torch.Tensor, cfg, state: SSMState
                       ) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent update: h = exp(dt A) h + dt B (x) x; y = C.h + D x.
    xin [B, 1, d]."""
    z, x, b, c, dt, a, tail, n_heads, d_in = _project(p, xin, cfg, state.conv)
    bsz = x.shape[0]
    xh = x.reshape(bsz, n_heads, cfg.ssm_head_dim).float()
    dt1 = dt[:, 0]  # [B,H]
    decay = torch.exp(dt1 * a[None, :])  # [B,H]
    b1, c1 = b[:, 0].float(), c[:, 0].float()  # [B,N]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xh, b1)
    h = state.h * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c1, h) + xh * p["D"][None, :, None]
    y = y.reshape(bsz, 1, d_in).to(xin.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    return y @ p["w_out"], SSMState(h=h, conv=tail)


def init_ssm_state(cfg, batch: int, device=None) -> SSMState:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return SSMState(
        h=torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                         dtype=torch.float32, device=device),
    )
