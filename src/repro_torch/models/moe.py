"""Mixture-of-Experts layer: top-k router + sort-based capacity dispatch.

PyTorch counterpart of `repro/models/moe.py`, same layouts (``router
[d, E]``, ``w_up``/``w_gate [E, d, f]``, ``w_down [E, f, d]``).  Dispatch is
gather/scatter (a stable sort by expert), so only active expert compute is
done on a grouped ``[E, C, d]`` buffer; tokens past an expert's capacity C
are dropped.  Token parity with the reference rests on three details:

  * the router's top-k keeps the lower expert index first among equal
    scores, as ``lax.top_k`` does (a stable descending sort; `torch.topk`
    documents no order for ties);
  * the dispatch sort is stable (``jnp.argsort`` is; torch's default sort
    is not);
  * dropped assignments add a zero row into slot 0 of their expert, as the
    reference's ``.at[...].add`` does, via ``index_put_(accumulate=True)``.

The expert products are plain batched matmuls outside any kernel, as the
reference leaves them to XLA.

On a mesh ``x`` is a DTensor and ``constrain`` the mesh's sharding hook
(`launch.sharding.make_constrain`), applied where the reference applies
it: the grouped buffer and the expert output to ``"moe_group"``, the
expert hidden to ``"moe_hidden"`` — experts over "model" where it divides
E, else TP inside each expert.  The routing is the reference's *global*
routing (capacity from the global token count, the S-major order that
decides the drops): the tokens (`tokens_s_major`) and the router logits
[T, E] are gathered whole on every rank; the sort, the counts and both
scatters run on those replicated plain tensors (identical on every rank,
so no DTensor sharding rule is involved); the buffer enters the mesh as a
replicated DTensor that ``constrain`` slices into its layout.  The expert
output is gathered whole for the combine, whose result re-enters as a
replicated DTensor, as does the aux loss (``dropped_frac`` stays a plain
tensor, the same on every rank).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MoEOutput(NamedTuple):
    out: torch.Tensor
    aux_loss: torch.Tensor  # load-balancing loss (scalar, f32)
    dropped_frac: torch.Tensor  # fraction of assignments dropped by capacity


def capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def _expert_act(up, gate, ffn_kind: str):
    if ffn_kind == "swiglu":
        return F.silu(gate) * up
    if ffn_kind == "relu2":
        r = F.relu(up)
        return r * r
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def _spread(a, mesh):
    """A plain tensor, the same on every rank, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)


def tokens_s_major(x: torch.Tensor) -> torch.Tensor:
    """[B, S, d] -> the S-major token matrix [S * B, d] that `apply_moe`
    routes (the order decides which assignments capacity drops).  A
    DTensor is replicated first: the routing gathers every token anyway,
    and a flatten over a sharded dim has no sharding rule in some torch
    releases (a size-1 mesh dim included)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    b, s, d = x.shape
    return x.transpose(0, 1).reshape(b * s, d)


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              ffn_kind: str, constrain=None) -> MoEOutput:
    """x [T, d] flat tokens -> MoEOutput(out [T, d] in x.dtype, aux, dropped).
    ``constrain(tensor, tag)`` is the sharding hook (the identity without
    a mesh)."""
    from torch.distributed.tensor import DTensor

    t, d = x.shape
    e = p["router"].shape[1]
    cap = capacity(t, e, top_k, capacity_factor)
    cid = constrain or (lambda a, _k: a)
    mesh = x.device_mesh if isinstance(x, DTensor) else None

    # f32 router logits: bf16 products are exact in f32 (the reference's
    # preferred_element_type=f32)
    logits = x.float() @ p["router"].float()
    if mesh is not None:  # route globally on the replicated [T, E] logits
        logits, x = logits.full_tensor(), x.full_tensor()
    dev = x.device
    probs = torch.softmax(logits, dim=-1)  # [T, E] f32
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalize

    # ---- sort-based dispatch ----
    flat_e = top_i.reshape(-1)  # [T*k]
    flat_w = top_p.reshape(-1)
    slots = torch.arange(t * top_k, device=dev)
    flat_t = slots // top_k  # owning token of each slot
    order = torch.argsort(flat_e, stable=True)
    se, sw, st = flat_e[order], flat_w[order], flat_t[order]
    # [E] tokens per expert (bincount's integers; index_add_ also runs on
    # meta tensors, which the dry run routes)
    counts = torch.zeros(e, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos = slots - start[se]  # position within the expert's bucket
    keep = pos < cap
    dropped = 1.0 - keep.float().mean()
    slot = torch.where(keep, pos, torch.zeros_like(pos))

    # scatter tokens into the [E, C, d] grouped buffer
    xin = torch.where(keep[:, None], x[st], torch.zeros((), dtype=x.dtype,
                                                        device=dev))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    buf.index_put_((se, slot), xin, accumulate=True)
    if mesh is not None:
        buf = _spread(buf, mesh)
    buf = cid(buf, "moe_group")  # [E, C, d] - EP sharding hint

    # ---- expert FFN on grouped tokens ----
    up = torch.bmm(buf, p["w_up"])
    gate = torch.bmm(buf, p["w_gate"]) if ffn_kind == "swiglu" else None
    h = cid(_expert_act(up, gate, ffn_kind), "moe_hidden")
    eout = cid(torch.bmm(h, p["w_down"]), "moe_group")  # [E, C, d]
    if mesh is not None:
        eout = eout.full_tensor()

    # ---- combine back (weighted scatter-add into tokens) ----
    contrib = eout[se, slot] * (sw * keep).to(eout.dtype)[:, None]  # [T*k, d]
    out = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    out.index_put_((st,), contrib, accumulate=True)
    if mesh is not None:
        out = _spread(out, mesh)

    # Switch-transformer load-balance aux: E * sum(frac_tokens * frac_prob)
    frac_tokens = counts.float() / (t * top_k)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    if mesh is not None:  # its gradient then arrives as a DTensor
        aux = _spread(aux, mesh)
    return MoEOutput(out.to(x.dtype), aux, dropped)
