"""Multi-master paged decode: the model-side plug for the paged kernel.

LoongServe §4.2 decodes with elastic instances: each master broadcasts its
query, every instance computes an unnormalized partial over the KV shard it
holds, and the master LSE-merges the partials.  `PagedDecodeAttnImpl` is
that dataflow behind the model's `attn_impl` seam: per layer it issues
exactly ONE `ops.paged_decode_partial` launch (K2) per instance — over the
instance's pool storage in place, routed by per-request block tables — then
merges the per-instance partials with the new token's own KV partial.  The
launch count is independent of batch size.

This is the reference's per-shard loop path on one device (no cross-device
transfer of q or partials); the SPMD mesh merges are ROADMAP queue 1 item
13.  Outside a `begin_step`/`end_step` window it behaves exactly like the
default dense math.
"""
from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional

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

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    pos: Optional[torch.Tensor] = None


class PagedDecodeAttnImpl(DefaultAttnImpl):
    """Batched paged decode attention across elastic instances."""

    def __init__(self):
        self._shards: Optional[List[PagedShard]] = None
        self._layer = 0
        self._n_planes: Optional[int] = None

    def begin_step(self, shards: List[PagedShard]) -> None:
        """Arm the paged path for one decode iteration.  decode_attn is
        called once per layer in stack order; the layer cursor indexes the
        per-layer storage planes."""
        self._shards = shards
        self._layer = 0
        # an empty shard list (no KV anywhere) leaves the cursor unverified
        self._n_planes = int(shards[0].k_pages.shape[0]) if shards else None

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
        part = attn.partial_attention(q, k_new, v_new, None, softcap=softcap)
        for s in self._shards:
            p = ops.paged_decode_partial(
                q, s.k_pages[li], s.v_pages[li], s.table, s.lengths, s.pos,
                query_pos=qpos, window=window, softcap=softcap,
            )
            ops.dispatch_counts["decode_merge_loop"] += 1
            part = attn.merge_partial(part, p)
        return attn.finalize_partial(part).to(q.dtype)
