"""Multi-master paged decode: the model-side plug for the paged kernel.

LoongServe §4.2 decodes with elastic instances: each master broadcasts its
query, every instance computes an unnormalized partial over the KV shard it
holds, and the master LSE-merges the partials.  `PagedDecodeAttnImpl` is
that dataflow behind the model's `attn_impl` seam: per layer it issues
exactly ONE `ops.paged_decode_partial` launch (K2) per instance — over the
instance's pool storage in place, routed by per-request block tables — then
merges the per-instance partials with the new token's own KV partial.  The
launch count is independent of batch size.

Three merge deployments behind the same arming call, as in the reference:

  * per-shard loop (default): partials merged sequentially.  In one process
    every shard is local.  Under the mesh executor a shard whose mirror
    lives in another process carries that process's rank (``src``): the
    owner computes the partial and broadcasts the tiny (o, m, l) to every
    rank (counted as ``decode_partial_home``) — the reference's
    "partial rides home".
  * SPMD (``mesh=``): each rank's partial over its own mirror, merged by a
    `pmax` + `psum` collective (`core.esp.paged_decode_spmd`).
  * batch-sharded (``axis_name=``, armed inside
    `core.esp.paged_decode_iteration_spmd`): each rank runs the stack on its
    B/n slice and the layer boundary is all_gather(q-slice) in /
    psum_scatter of the merged output back to the batch shards.

Outside a `begin_step`/`end_step` window it behaves exactly like the default
dense math.
"""
from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.transformer import DefaultAttnImpl


class PagedShard(NamedTuple):
    """One instance's share of a decode batch.

    k_pages/v_pages: [n_attn, n_pages, P, KVH, D] device mirror of the
    instance's pool storage; table/lengths: that pool's block table for the
    batch; pos: [n_pages, P] global position per slot — only needed for
    sliding-window masking."""

    k_pages: Optional[torch.Tensor]
    v_pages: Optional[torch.Tensor]
    table: Optional[torch.Tensor]
    lengths: Optional[torch.Tensor]
    pos: Optional[torch.Tensor] = None
    # global rank holding this shard's mirror when it lives in another
    # process of the mesh (it computes the partial and broadcasts it; the
    # tensors above are None elsewhere); None = a local shard
    src: Optional[int] = None


class SpmdPagedShards(NamedTuple):
    """This rank's share of an SPMD decode group: its own pool mirror (the
    reference's mesh-sharded operand without its leading rank axis — each
    process holds only its own mirror, zero KV movement) and the group's
    block table over it.

    k_pages/v_pages: [n_attn, n_pages, P, KVH, D]; table [B, max_pages];
    lengths [B]; pos [n_pages, P] (window only)."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    pos: Optional[torch.Tensor] = None


class PagedDecodeAttnImpl(DefaultAttnImpl):
    """Batched paged decode attention across elastic instances."""

    def __init__(self):
        self._shards: Optional[Union[List[PagedShard], SpmdPagedShards]] = None
        self._layer = 0
        self._n_planes: Optional[int] = None
        self._mesh = None  # SPMD mode: collective merge (esp.paged_decode_spmd)
        self._overlap = True
        self._axis = None  # batch-sharded mode: the axis' process group
        self._n_ranks = 1
        self._qpos_full = None

    def begin_step(self, shards, *, mesh=None, overlap: bool = True,
                   axis_name=None, n_ranks: int = 1, query_pos=None) -> None:
        """Arm the paged path for one decode iteration.  decode_attn is
        called once per layer in stack order; the layer cursor indexes the
        per-layer storage planes.  With ``mesh=`` the shards are this rank's
        `SpmdPagedShards` and each layer's merge is a collective over the
        mesh's "data" axis; ``overlap=False`` waits for the reduce before
        the new-token partial.  With ``axis_name=`` (the axis' process group,
        ``n_ranks`` its size) the impl is armed inside the batch-sharded
        iteration and ``query_pos`` is the FULL [B] cached-length vector
        (the all-gathered query needs full-batch masking while the stack
        sees only the rank's slice)."""
        self._shards = shards
        self._layer = 0
        self._mesh = mesh
        self._overlap = overlap
        self._axis = axis_name
        self._n_ranks = n_ranks
        self._qpos_full = query_pos
        if mesh is not None or axis_name is not None:
            assert isinstance(shards, SpmdPagedShards), type(shards)
            self._n_planes = int(shards.k_pages.shape[0])
        else:
            # an empty shard list (no KV anywhere) or a remote first shard
            # leaves the cursor unverified
            first = shards[0].k_pages if shards else None
            self._n_planes = int(first.shape[0]) if first is not None else None

    def end_step(self) -> None:
        """Disarm — and verify the layer cursor consumed EXACTLY the armed
        per-layer planes (skipped while another exception propagates, so a
        model error stays the headline failure)."""
        try:
            if (self._shards is not None and self._n_planes is not None
                    and sys.exc_info()[0] is None):
                assert self._layer == self._n_planes, (
                    f"paged decode consumed {self._layer} layer planes, "
                    f"pool stores {self._n_planes}"
                )
        finally:
            self._shards = None
            self._n_planes = None
            self._layer = 0
            self._mesh = None
            self._overlap = True
            self._axis = None
            self._n_ranks = 1
            self._qpos_full = None

    def decode_attn(self, q, k_cache, v_cache, k_new, v_new, cache_len, *,
                    window, softcap):
        if self._shards is None or k_cache is not None:
            return super().decode_attn(
                q, k_cache, v_cache, k_new, v_new, cache_len,
                window=window, softcap=softcap,
            )
        li = self._layer
        self._layer += 1
        if self._n_planes is not None:
            assert li < self._n_planes, (
                f"decode_attn called for layer {li} but the pool stores "
                f"{self._n_planes} planes (model/impl stack mismatch)"
            )
        b = q.shape[0]
        # the query's global position == cached token count (its own KV is
        # k_new, merged below) — window predicate qp - kp < window
        qpos = torch.as_tensor(cache_len, device=q.device).expand(b).to(torch.int32)
        if self._axis is not None:
            from repro_torch.core.esp import paged_decode_attn_sharded

            s = self._shards
            out = paged_decode_attn_sharded(
                self._axis, self._n_ranks, q, k_new, v_new, self._qpos_full,
                s.k_pages[li], s.v_pages[li], s.table, s.lengths, s.pos,
                window=window, softcap=softcap, overlap=self._overlap,
            )
            return out.to(q.dtype)
        if self._mesh is not None:
            from repro_torch.core.esp import paged_decode_spmd

            s = self._shards
            out = paged_decode_spmd(
                self._mesh, q, k_new, v_new, qpos, s.k_pages[li],
                s.v_pages[li], s.table, s.lengths, s.pos, window=window,
                softcap=softcap, overlap=self._overlap,
            )
            return out.to(q.dtype)
        part = attn.partial_attention(q, k_new, v_new, None, softcap=softcap)
        for s in self._shards:
            p = shard_partial(
                s.src, tuple(q.shape),
                lambda s=s: ops.paged_decode_partial(
                    q, s.k_pages[li], s.v_pages[li], s.table, s.lengths,
                    s.pos, query_pos=qpos, window=window, softcap=softcap,
                ),
                q.device,
            )
            # counted so SPMD tests can assert the sequential loop merge is
            # never reached when the mesh path is armed
            ops.dispatch_counts["decode_merge_loop"] += 1
            part = attn.merge_partial(part, p)
        return attn.finalize_partial(part).to(q.dtype)


def shard_partial(src: Optional[int], shape, compute, device) -> attn.Partial:
    """One shard's partial of shape ``shape`` = (B, Sq, H, D): computed here
    (``src`` None), or computed by the rank ``src`` that holds the shard's
    mirror and broadcast to every rank of the world — the partial riding
    home (``decode_partial_home`` in `ops.comm_bytes`).  Every rank must
    call it for the same shards in the same order."""
    if src is None:
        return compute()
    import torch.distributed as dist

    if dist.get_rank() == src:
        p = attn.Partial(*(x.contiguous() for x in compute()))
    else:
        p = attn.empty_partial(*shape, device=device)
    ops.broadcast(tuple(p), src, key="decode_partial_home")
    return p
