"""Unified continuous-batching attention: chunked prefill + in-flight decode
on ONE packed ragged token axis (the LoongServe unified iteration).

The port's counterpart of the in-process half of `repro/core/unified.py`.
Decode IS chunked prefill with chunk == 1: per layer, every packed token
row's attention output is

    finalize( merge( paged PREFIX partial over the pool storage,
                     packed causal CHUNK partial over this iteration's axis ) )

The prefix partial is the paged decode primitive (`ops.paged_decode_partial`,
K2) with PER-TOKEN operands: each packed token carries its request's page
table and the length of the FILLED prefix (`KVPool.prefix_block_table`), so
a mid-prefill request attends exactly the chunks it has already written.
The chunk partial is the ring-step primitive (`ops.prefill_ring_chunk`, K3)
with ``n_shards=1`` and the merged prefix partial passed in as its carried
flash state.  A decode row is a length-1 segment, so its chunk partial is
the new token's self-attention partial.

Every prefix position lies below its chunk's first position, so the prefix
partial needs no causal mask beyond slot validity (plus the per-token window
predicate on global positions).  Nothing assumes a chunk starts at the
request's prefill frontier, only that the pool holds every position below
the chunk's start: the salvage recovery chain replays a lost span as
ordinary chunks through this same iteration.

Under the mesh executor the same iteration runs across processes: a
shard whose pool mirror lives in another process carries that process's
rank (``src``) and its prefix partial is computed there and broadcast
(`core.paged_decode.shard_partial`); and the SPMD form
(`core.esp.unified_iteration_spmd`) stripes the token axis over the group,
the prefix plane merged by collectives and the chunk plane folded by the
ring (`UnifiedAttnImpl._attn_axis`).
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models.transformer import DefaultAttnImpl


class UnifiedShard(NamedTuple):
    """One instance's pool view for a unified step, with PER-TOKEN paged
    operands: row t of ``table``/``lengths`` is packed token t's page table
    and filled-prefix length in THIS pool (0 where the pool holds nothing
    for that token's request)."""

    k_pages: torch.Tensor  # [L, n_pages, P, KVH, D]
    v_pages: torch.Tensor  # [L, n_pages, P, KVH, D]
    page_pos: Optional[torch.Tensor]  # [n_pages, P] (window masking only)
    table: torch.Tensor  # [T, max_pages] int32
    lengths: torch.Tensor  # [T] int32
    # global rank holding the mirror when it lives in another process
    # (the tensors are None elsewhere); None = a local shard
    src: Optional[int] = None


def unified_chunk_attention(q, k, v, seq_offsets, positions, prefix_shards, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """One layer of unified attention, single-process form.

    q/k/v [T, H|KVH, D]: this iteration's packed token axis (prefill chunks
    then decode rows); ``seq_offsets`` [S+1] its segment boundaries;
    ``positions`` [T] global positions; ``prefix_shards``: iterable of
    per-layer pool views ``(k_pages [n_pages,P,KVH,D], v_pages, table
    [T,max_pages], lengths [T], page_pos[, src])``.  One K2 launch per shard
    (on the rank ``src`` for a shard held by another process), the partials
    LSE-merged, then one K3 launch folding the chunk into them.  Returns the
    normalized [T, H, D] f32 output."""
    from repro_torch.core.paged_decode import shard_partial

    carry = None
    qt = q[:, None]  # [T, 1, H, D]: token axis as the partial's batch axis
    for view in prefix_shards:
        kp, vp, tbl, lens, pos = view[:5]
        src = view[5] if len(view) > 5 else None
        p = shard_partial(
            src, tuple(qt.shape),
            lambda kp=kp, vp=vp, tbl=tbl, lens=lens, pos=pos:
                ops.paged_decode_partial(qt, kp, vp, tbl, lens, pos,
                                         query_pos=positions, window=window,
                                         softcap=softcap),
            q.device,
        )
        carry = p if carry is None else A.merge_partial(carry, p)
    if carry is not None:
        carry = (carry.o[:, 0], carry.m[:, 0], carry.l[:, 0])
    o, m, l = ops.prefill_ring_chunk(
        q, k, v, seq_offsets, seq_offsets, carry, q_shard=0, k_shard=0,
        n_shards=1, window=window, softcap=softcap,
    )
    denom = torch.where(l == 0.0, torch.ones((), device=l.device), l)
    return o / denom[..., None]  # l == 0 rows are bucket padding


class UnifiedAttnImpl(DefaultAttnImpl):
    """Attention impl for the unified iteration, armed per engine step.

    Drives `model.prefill_packed`: the layer loop calls `prefill_attn` once
    per layer and the impl keeps a layer cursor into the per-layer pool
    planes (the begin/end contract of `core.paged_decode.PagedDecodeAttnImpl`).
    Outside a `begin_step`/`end_step` window it is the default attention.

    Two modes:
      * loop: ``shards`` is a list of `UnifiedShard`, one per instance
        holding prefix KV; each layer merges one prefix partial per shard
        into the chunk fold;
      * axis (``axis_name=``, inside `esp.unified_iteration_spmd`): the
        token axis is STRIPED over ``n_ranks`` processes; each layer
        all-gathers the q stripes, computes this rank's prefix partial over
        its own pool plane, LSE-merges with pmax + psum_scatter back to the
        stripes, and folds the chunk with the striped KV ring of the SPMD
        prefill.
    """

    def __init__(self):
        self._armed = False
        self._shards: list = []

    def begin_step(self, seq_offsets, positions, *,
                   shards: Optional[Sequence[UnifiedShard]] = None,
                   axis_name=None, n_ranks: int = 1,
                   double_buffer: bool = True) -> None:
        """Arm one step.  ``positions`` is the FULL packed-axis position
        vector ([T] on the model's device; striped order in axis mode): the
        prefix partial's per-token query positions.  In axis mode
        ``axis_name`` is the axis' process group, ``shards`` holds ONE
        `UnifiedShard` with this rank's pool plane and per-token operands
        over the full striped axis, and ``seq_offsets`` are the GLOBAL
        packed offsets (numpy)."""
        assert not self._armed, "unified step already armed"
        self._offsets = seq_offsets
        self._positions = positions
        self._shards = list(shards) if shards else []
        self._axis = axis_name
        self._n_ranks = n_ranks
        self._double_buffer = double_buffer
        self._li = 0
        first = self._shards[0].k_pages if self._shards else None
        self._n_layers = int(first.shape[0]) if first is not None else None
        self._armed = True

    def end_step(self) -> None:
        """Disarm, and check the cursor consumed exactly the armed planes
        (skipped while another exception propagates)."""
        assert self._armed
        li, n = self._li, self._n_layers
        self._armed = False
        self._shards = []
        if sys.exc_info()[0] is None and n is not None:
            assert li == n, (li, n)

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        if not self._armed:
            return super().prefill_attn(q, k, v, q_pos, k_pos, causal=causal,
                                        window=window, softcap=softcap)
        assert causal and q.shape[0] == 1, (causal, q.shape)
        li = self._li
        self._li += 1
        if self._axis is not None:
            return self._attn_axis(li, q, k, v, window, softcap)[None].to(
                q.dtype)
        shards_li = [
            (s.k_pages[li] if s.k_pages is not None else None,
             s.v_pages[li] if s.v_pages is not None else None,
             s.table, s.lengths, s.page_pos, s.src)
            for s in self._shards
        ]
        out = unified_chunk_attention(
            q[0], k[0], v[0], self._offsets, self._positions, shards_li,
            window=window, softcap=softcap,
        )
        return out[None].to(q.dtype)

    def _attn_axis(self, li, q, k, v, window, softcap):
        """One layer boundary of the striped SPMD iteration: decode-style
        prefix merge + prefill-style ring fold, on this rank's token
        stripe."""
        import torch.distributed as dist

        from repro_torch.core import esp

        group, n = self._axis, self._n_ranks
        (sh,) = self._shards
        tl = q.shape[1]
        r = dist.get_rank(group)
        # prefix plane: all_gather(q) -> K2 over this rank's pool plane ->
        # LSE psum_scatter back to the stripes (the batch-sharded decode
        # boundary, with T for B)
        qg = ops.all_gather(q[0][:, None], group, axis=0)  # [T, 1, H, D]
        part = ops.paged_decode_partial(
            qg, sh.k_pages[li], sh.v_pages[li], sh.table, sh.lengths,
            sh.page_pos, query_pos=self._positions, window=window,
            softcap=softcap,
        )
        m_g = ops.pmax(part.m, group)
        w = esp._lse_weights(part, m_g)
        o_s, l_s = ops.psum_scatter((part.o * w[..., None], part.l * w),
                                    group, scatter_dimension=0)
        m_s = m_g[r * tl:(r + 1) * tl]
        carry = (o_s[:, 0], m_s[:, 0], l_s[:, 0])
        # chunk plane: the striped KV ring of this iteration's packed axis,
        # folded into the prefix carry
        carry = esp._ring_fold(
            group, n, r, q[0], k[0], v[0], self._offsets, carry,
            window=window, softcap=softcap,
            double_buffer=self._double_buffer,
        )
        return esp._finalize_carry(carry)
