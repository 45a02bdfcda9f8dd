"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel prefill) and sLSTM
(scalar memory, a sequential scan) — the PyTorch counterpart of
`repro/models/xlstm.py`, function for function.

The mLSTM chunkwise form is the TFLA formulation with max-stabilized
exponential gating; the chunk-final (C, n, m) state is the sequence-parallel
handoff object (`mlstm_state_only` / `mlstm_combine_states`).  Decode is an
O(1) recurrent step for both cells.  Nothing here is a kernel in the
reference, so plain PyTorch is the port: the reference's `lax.scan` over
chunks (mLSTM) and over time (sLSTM) is a Python loop of tensor ops with no
host synchronization inside.  The parameters (the reference's
`init_mlstm` / `init_slstm` trees) are drawn by `repro_torch.convert`.

Numerics follow the reference's order of operations: the stabilizer ``m``
starts at -inf and is only ever combined as ``max(finite, -inf)`` before it
is subtracted, so no ``inf - inf`` appears (`torch.maximum` propagates NaN).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import census

# padding of a prompt to a chunk multiple: the input gate -> -1e9 (no
# contribution), the forget gate -> +40 (log sigmoid ~ 0: the state passes
# through unchanged)
_PAD_IG = -1e9
_PAD_FG = 40.0


class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, Dv, Dk] f32 matrix memory
    n: torch.Tensor  # [B, H, Dk] f32 normalizer
    m: torch.Tensor  # [B, H] f32 stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, D_in] f32
    n: torch.Tensor  # [B, D_in]
    h: torch.Tensor  # [B, D_in]
    m: torch.Tensor  # [B, D_in]


def _d_inner(cfg) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


# ------------------------------------------------------------------ mLSTM


def _mlstm_qkvif(p, x, cfg):
    d_in = _d_inner(cfg)
    h = cfg.n_heads
    dh = d_in // h
    b, t = x.shape[0], x.shape[1]
    up = x @ p["w_up"]
    xm, z = up[..., :d_in], up[..., d_in:]
    q = (xm @ p["w_q"]).view(b, t, h, dh)
    k = (xm @ p["w_k"]).view(b, t, h, dh)
    v = (xm @ p["w_v"]).view(b, t, h, dh)
    o = torch.sigmoid(xm @ p["w_o"])
    gif = (xm @ p["w_if"]).float()
    ig = gif[..., :h] + p["b_i"]
    fg = gif[..., h:] + p["b_f"]
    return q, k, v, o, ig, fg, z, dh


def _pad_time(chunk, *tensors):
    """Pad [B, T, ...] tensors to a chunk multiple on T (zeros); returns
    (pad, padded tensors)."""
    t = tensors[0].shape[1]
    pad = (-t) % chunk
    if not pad:
        return 0, tensors
    out = []
    for a in tensors:
        widths = [0, 0] * (a.ndim - 2) + [0, pad]
        out.append(F.pad(a, widths))
    return pad, tuple(out)


def _pad_gates(pad, ig, fg):
    if not pad:
        return ig, fg
    return (F.pad(ig, (0, 0, 0, pad), value=_PAD_IG),
            F.pad(fg, (0, 0, 0, pad), value=_PAD_FG))


def _chunks(a, nc, chunk):
    """[B, T, ...] -> nc views [B, L, ...]."""
    return a.reshape(a.shape[0], nc, chunk, *a.shape[2:]).unbind(1)


def mlstm_chunkwise(
    q, k, v, ig, fg, chunk: int, state: Optional[MLSTMState] = None
) -> Tuple[torch.Tensor, MLSTMState]:
    """q,k,v: [B,T,H,Dh]; ig,fg: [B,T,H] raw gates.  Returns
    ([B,T,H,Dh] in q's dtype, state)."""
    bsz, t_orig, h, dh = q.shape
    pad, (q, k, v) = _pad_time(chunk, q, k, v)
    ig, fg = _pad_gates(pad, ig, fg)
    t = t_orig + pad
    nc = t // chunk
    scale = dh ** -0.5
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    logf = F.logsigmoid(fg.float())  # [B,T,H]
    if state is None:
        state = init_mlstm_state_raw(bsz, h, dh, dh, device=q.device)
    ii = torch.arange(chunk, device=q.device)
    tri = (ii[:, None] >= ii[None, :])[None, :, :, None]  # causal in chunk
    c_prev, n_prev, m_prev = state
    hs = []
    for qk_, kk_, vk_, gk_, lfk_ in zip(
            _chunks(qf, nc, chunk), _chunks(kf, nc, chunk),
            _chunks(vf, nc, chunk), _chunks(ig.float(), nc, chunk),
            _chunks(logf, nc, chunk)):
        with census.scope("mlstm_chunk_body"):
            b = torch.cumsum(lfk_, dim=1)  # [B,L,H] inclusive cumsum of logf
            # stabilizers
            m_intra = b + torch.cummax(gk_ - b, dim=1).values  # [B,L,H]
            m_inter = b + m_prev[:, None, :]
            m_i = torch.maximum(m_intra, m_inter)
            # inter-chunk contribution
            w_inter = torch.exp(m_inter - m_i)
            num_inter = torch.einsum("blhk,bhvk->blhv", qk_, c_prev) * w_inter[..., None]
            den_inter = torch.einsum("blhk,bhk->blh", qk_, n_prev) * w_inter
            # intra-chunk scores
            s = torch.einsum("bihk,bjhk->bijh", qk_, kk_)  # [B,L,L,H]
            dmat = (b[:, :, None, :] - b[:, None, :, :] + gk_[:, None, :, :]
                    - m_i[:, :, None, :])
            s = s * torch.where(tri, torch.exp(dmat), torch.zeros((), device=s.device))
            num = num_inter + torch.einsum("bijh,bjhv->bihv", s, vk_)
            den = den_inter + s.sum(dim=2)  # [B,L,H]
            hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
            # chunk-final state
            btot = b[:, -1, :]  # [B,H]
            m_loc = (btot[:, None, :] - b + gk_).amax(dim=1)
            m_new = torch.maximum(btot + m_prev, m_loc)
            wj = torch.exp(btot[:, None, :] - b + gk_ - m_new[:, None, :])  # [B,L,H]
            carry = torch.exp(btot + m_prev - m_new)
            c_prev = c_prev * carry[:, :, None, None] + torch.einsum(
                "blh,blhv,blhk->bhvk", wj, vk_, kk_)
            n_prev = n_prev * carry[:, :, None] + torch.einsum("blh,blhk->bhk", wj, kk_)
            m_prev = m_new
    out = torch.cat(hs, dim=1)[:, :t_orig]
    return out.to(q.dtype), MLSTMState(c_prev, n_prev, m_prev)


def mlstm_state_only(
    k, v, ig, fg, chunk: int, state: Optional[MLSTMState] = None
) -> Tuple[MLSTMState, torch.Tensor]:
    """Segment-state fold for sequence parallelism: chunk-final (C, n, m)
    from `state` (default zero / -inf identity) plus the segment's total
    log-forget mass btot [B,H].  Skips all output math."""
    bsz, t_orig, h, dh = k.shape
    pad, (k, v) = _pad_time(chunk, k, v)
    ig, fg = _pad_gates(pad, ig, fg)
    nc = (t_orig + pad) // chunk
    logf = F.logsigmoid(fg.float())
    if state is None:
        state = init_mlstm_state_raw(bsz, h, dh, dh, device=k.device)
    c_prev, n_prev, m_prev = state
    bacc = torch.zeros((bsz, h), dtype=torch.float32, device=k.device)
    for kk_, vk_, gk_, lfk_ in zip(
            _chunks(k.float(), nc, chunk), _chunks(v.float(), nc, chunk),
            _chunks(ig.float(), nc, chunk), _chunks(logf, nc, chunk)):
        b = torch.cumsum(lfk_, dim=1)
        btot = b[:, -1, :]
        m_loc = (btot[:, None, :] - b + gk_).amax(dim=1)
        m_new = torch.maximum(btot + m_prev, m_loc)
        wj = torch.exp(btot[:, None, :] - b + gk_ - m_new[:, None, :])
        scale = torch.exp(btot + m_prev - m_new)
        c_prev = c_prev * scale[:, :, None, None] + torch.einsum(
            "blh,blhv,blhk->bhvk", wj, vk_, kk_)
        n_prev = n_prev * scale[:, :, None] + torch.einsum("blh,blhk->bhk", wj, kk_)
        m_prev = m_new
        bacc = bacc + btot
    return MLSTMState(c_prev, n_prev, m_prev), bacc


def mlstm_combine_states(
    s1: MLSTMState, s2: MLSTMState, btot2: torch.Tensor
) -> MLSTMState:
    """Monoid combine: s1 followed by a segment with state s2 / log-forget
    mass btot2 (max-stabilized log-space)."""
    zero = torch.zeros((), device=s1.m.device)
    m = torch.maximum(s1.m + btot2, s2.m)
    m_safe = torch.where(torch.isinf(m), zero, m)
    w1 = torch.where(torch.isinf(s1.m), zero, torch.exp(s1.m + btot2 - m_safe))
    w2 = torch.where(torch.isinf(s2.m), zero, torch.exp(s2.m - m_safe))
    return MLSTMState(
        c=s1.c * w1[..., None, None] + s2.c * w2[..., None, None],
        n=s1.n * w1[..., None] + s2.n * w2[..., None],
        m=m,
    )


def mlstm_step(q, k, v, ig, fg, state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """One decode step. q,k,v [B,H,Dh]; ig,fg [B,H]."""
    dh = q.shape[-1]
    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()
    logf = F.logsigmoid(fg.float())
    igf = ig.float()
    m_new = torch.maximum(logf + state.m, igf)
    fprime = torch.exp(logf + state.m - m_new)
    iprime = torch.exp(igf - m_new)
    c = state.c * fprime[..., None, None] + iprime[..., None, None] * torch.einsum(
        "bhv,bhk->bhvk", vf, kf)
    n = state.n * fprime[..., None] + iprime[..., None] * kf
    num = torch.einsum("bhk,bhvk->bhv", qf, c)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(), torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), MLSTMState(c, n, m_new)


def mlstm_block_forward(p, x, cfg, state=None, *, chunk: Optional[int] = None):
    """x: [B,T,d] (post-norm).  Returns (out [B,T,d], MLSTMState).  The
    chunk is ``min(cfg.ssm_chunk or 64, T)``: it depends on the prompt."""
    q, k, v, o, ig, fg, z, dh = _mlstm_qkvif(p, x, cfg)
    ck = chunk or (cfg.ssm_chunk if cfg.ssm_chunk else 64)
    ck = min(ck, x.shape[1])
    htilde, st = mlstm_chunkwise(q, k, v, ig, fg, ck, state)
    h = htilde.reshape(x.shape[0], x.shape[1], -1) * o
    h = h * F.silu(z)
    return h @ p["w_down"], st


def mlstm_block_step(p, x, cfg, state: MLSTMState):
    """x: [B,1,d]."""
    q, k, v, o, ig, fg, z, dh = _mlstm_qkvif(p, x, cfg)
    htilde, st = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0], state)
    h = htilde.reshape(x.shape[0], 1, -1) * o
    h = h * F.silu(z)
    return h @ p["w_down"], st


def init_mlstm_state_raw(b, h, dv, dk, device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((b, h, dv, dk), dtype=torch.float32, device=device),
        n=torch.zeros((b, h, dk), dtype=torch.float32, device=device),
        m=torch.full((b, h), -torch.inf, dtype=torch.float32, device=device),
    )


def init_mlstm_state(cfg, batch: int, device=None) -> MLSTMState:
    dh = _d_inner(cfg) // cfg.n_heads
    return init_mlstm_state_raw(batch, cfg.n_heads, dh, dh, device=device)


# ------------------------------------------------------------------ sLSTM


def slstm_scan(p, xm, cfg, state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """xm: [B,T,d_in] pre-activation input; sequential over T (a Python
    loop of tensor ops: nothing in it waits for the device)."""
    d_in = _d_inner(cfg)
    h = cfg.n_heads
    dh = d_in // h
    wx = (xm @ p["w_zifo"]).float()  # [B,T,4*d_in]
    r = p["r_zifo"].float()
    bias = p["b_zifo"].float()
    c, n, hid, m = state
    hs = []
    for wxt in wx.unbind(1):
        with census.scope("slstm_step_body"):
            rec = torch.einsum("bhd,ghde->bghe", hid.reshape(-1, h, dh), r)
            pre = wxt + rec.reshape(-1, 4 * d_in) + bias
            zt = torch.tanh(pre[:, :d_in])
            it = pre[:, d_in:2 * d_in]
            ft = pre[:, 2 * d_in:3 * d_in]
            ot = torch.sigmoid(pre[:, 3 * d_in:])
            m_new = torch.maximum(ft + m, it)
            iprime = torch.exp(it - m_new)
            fprime = torch.exp(ft + m - m_new)
            c = fprime * c + iprime * zt
            n = fprime * n + iprime
            hid = ot * (c / n)
            m = m_new
            hs.append(hid)
    out = torch.stack(hs, dim=1)  # [B,T,d_in]
    return out.to(xm.dtype), SLSTMState(c, n, hid, m)


def slstm_block_forward(p, x, cfg, state=None):
    d_in = _d_inner(cfg)
    up = x @ p["w_up"]
    xm, z = up[..., :d_in], up[..., d_in:]
    if state is None:
        state = init_slstm_state(cfg, x.shape[0], device=x.device)
    hseq, st = slstm_scan(p, xm, cfg, state)
    h = hseq * F.silu(z)
    return h @ p["w_down"], st


def slstm_block_step(p, x, cfg, state: SLSTMState):
    return slstm_block_forward(p, x, cfg, state)


def init_slstm_state(cfg, batch: int, device=None) -> SLSTMState:
    d_in = _d_inner(cfg)
    zeros = torch.zeros((batch, d_in), dtype=torch.float32, device=device)
    return SLSTMState(
        c=zeros,
        n=torch.full((batch, d_in), 1e-6, dtype=torch.float32, device=device),
        h=zeros.clone(),
        m=zeros.clone(),
    )
